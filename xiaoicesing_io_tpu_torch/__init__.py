"""PyTorch / CUDA port of the xiaoicesing_io_tpu singing-voice-synthesis framework.

The package mirrors the JAX package's module paths and imports nothing from
it.  Modules keep the reference DiffSinger state-dict names, so reference
checkpoints load with ``load_state_dict``.  Entry points run on CUDA unless
the caller passes ``device="cpu"``.
"""
