"""Host signal processing (numpy): the f0 tracker."""
