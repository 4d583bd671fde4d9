"""Model assembly (training itself is not ported yet)."""
