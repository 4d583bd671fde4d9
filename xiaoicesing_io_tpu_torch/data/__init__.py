"""Binarized datasets: the HDF5 item store and the batch collators."""
