"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

| module            | replaces (TPU kernel)                                                   |
| ----------------- | ----------------------------------------------------------------------- |
| ``lynx_conv``     | ``xiaoicesing_io_tpu/ops/pallas/lynx_conv.py:lynx_conv_module``         |
| ``hifigan_stage`` | ``xiaoicesing_io_tpu/ops/pallas/hifigan_stage.py:fused_resblock_stage`` |
| ``wavenet_block`` | ``xiaoicesing_io_tpu/ops/pallas/wavenet_block.py:wavenet_block``        |
| ``mel_spec``      | ``xiaoicesing_io_tpu/ops/pallas/mel_kernel.py:PallasMelSpectrogram``    |

Sources live in ``csrc/`` and are built by :mod:`.build` at first use.
"""
