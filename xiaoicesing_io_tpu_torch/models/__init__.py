"""Model modules of the port (reference DiffSinger parameter names)."""
