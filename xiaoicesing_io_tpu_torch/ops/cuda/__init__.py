"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

| module              | replaces (TPU kernel)                                                     |
| ------------------- | ------------------------------------------------------------------------- |
| ``lynx_conv``       | ``xiaoicesing_io_tpu/ops/pallas/lynx_conv.py:lynx_conv_module``           |
| ``hifigan_stage``   | ``xiaoicesing_io_tpu/ops/pallas/hifigan_stage.py:fused_resblock_stage``   |
| ``hifigan_resblock``| ``xiaoicesing_io_tpu/ops/pallas/hifigan_resblock.py:resblock_unit``       |
| ``wavenet_block``   | ``xiaoicesing_io_tpu/ops/pallas/wavenet_block.py:wavenet_block``          |
| ``mel_spec``        | ``xiaoicesing_io_tpu/ops/pallas/mel_kernel.py:PallasMelSpectrogram``      |
| ``lynx_layer``      | ``xiaoicesing_io_tpu/ops/pallas/lynx_conv2.py:lynx_layer_fused``,         |
|                     | ``xiaoicesing_io_tpu/ops/pallas/lynx_conv3.py:lynx_layer_fused_v3``       |
| ``lynx_hybrid``     | ``xiaoicesing_io_tpu/ops/pallas/lynx_hybrid.py:lynx_conv_module_hybrid``  |

Sources live in ``csrc/`` and are built by :mod:`.build` at first use.
``lynx_conv``, ``lynx_layer``, ``lynx_hybrid``, ``wavenet_block``,
``hifigan_stage`` and ``hifigan_resblock`` run their products on the Hopper
GEMM core ``csrc/sm90_gemm.cuh`` (``lynx_layer``'s K7 on its persistent
entry), whose host-side plan is :mod:`.sm90`; ``lynx_conv``, ``lynx_layer``
and ``lynx_hybrid`` share the conv pass of ``csrc/lynx_passes.cuh``.
``mel_spec`` is an FFT, one warp a frame in registers, whose host-side plan
is in its own module.
"""
