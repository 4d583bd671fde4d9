#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. the card (name and power limit, from nvidia-smi);
  2. the build of every CUDA kernel from ``xiaoicesing_io_tpu_torch/csrc``,
     then one line a compiled kernel from its ``-Xptxas -v`` log: its name
     with its template arguments, registers, stack frame and spill bytes
     (marked ``SPILLS`` where it spills);
  3. K1 ``lynx_conv_module`` against its plain PyTorch version at three edge
     shapes (T off the 128-row tile and the conv's 64-row block, k 31, 32
     and 3, dim 1024 and 256) and at the LYNXNet path's shape (B=4, T=2048,
     dim 1024, inner 2048, k 31; bf16); at the latter its time, the time of
     its two products as cuBLAS bf16 products (``gemm_library_ms``, the
     yardstick of the GEMM core ``csrc/sm90_gemm.cuh``), the host
     microseconds per wrapper call and the device time of each of its passes
     (``torch.profiler``);
  4. K2 ``fused_resblock_stage`` against its plain version at vocoder stages 0
     and 1 of the same batch (L=256 at T*8 rows, L=128 at T*64 rows; bf16);
     per stage its time, the unfused bf16 cuDNN chain's, ``gemm_library_ms``
     (each conv's taps as one cuBLAS product ``[rows, L] @ [L, k L]``, the
     products alone), the host microseconds per call and the device split of
     its leaky-ReLU pass, first convs and second convs; then both stages at
     B=2 with T off the tile (873 frames), as serving's vocoder groups run;
  5. K4 ``wavenet_block`` against its plain version at three edge shapes (T
     off the tile, d 64, C 192 and 256) and at the WaveNet path's shape (B=4,
     T=2048, C=512) for each dilation d of its cycle, 1, 2, 4, 8; its
     ``gemm_library_ms`` (the three tap products and the output product as
     cuBLAS bf16 products), host microseconds per call and per-launch device
     times as for K1; then K4 at the variance model's heads, B=1, T=256 and
     1024, C=256 and 192 (the pitch and multi-variance WaveNets), d=16 and 8,
     each held against its plain version and timed beside its plain version
     and ``gemm_library_ms``, with its device time alone (``device_ms``);
  6. the LYNXNet + rectified-flow configuration (``configs/acoustic.json``)
     at full width with random weights: one sample ``.ds``, every segment,
     through the port's ``DiffSingerAcousticInfer.run_inference`` and the
     NSF-HiFiGAN vocoder in its default time-folded layout (the launch
     counters are zeroed just before it and read just after); the wav must
     be finite and of the right length, K1 must have launched once per layer
     per step per segment (6 x 20 x 10), and per segment's vocoder call K2
     exactly twice (stages 0 and 1) and K6 exactly 27 times (the ResBlock1
     units of stages 2-4).  Then every segment's mel and wav against the
     bench's plain f32 reference (``bench/reference.py``) from the same
     inputs and seeds, and the song must be its segments placed.  Then a
     batched timing at B=4, T=2048, 20 Euler steps;
  7. the WaveNet + DDPM configuration (the same file with a 512 x 20 WaveNet,
     dilation cycle 4, and a linear 1000-step DDPM core, K_step 400, DDIM at
     speedup 10: 40 steps), at full width with random weights saved under the
     reference names (``diffusion.denoise_fn.*`` and the schedule buffers):
     the same ``.ds`` run, where K4 must launch 20 x 40 times per segment
     and K2 and K6 as in phase 6, the same check against the reference, and a
     batched timing through the bench's cell ``wavenet_ddpm_b4_t2048`` (40
     DDIM steps) at 2 runs;
  7b. the variance -> acoustic pipeline at full width with random weights
     under the reference names: a variance model at the shipped widths of
     ``configs/variance.json`` (fs2 256 x 4, durations 512 x 5, pitch
     WaveNet 256 x 20 at cycle 5, variance WaveNet 192 x 10 at cycle 4 with
     energy, breathiness, voicing and tension, 2 speakers, reflow, 20 Euler
     steps from t = 0) runs ``DiffSingerVarianceInfer.run_inference`` on the
     sample ``.ds`` stripped of ``ph_dur``, ``f0_seq`` and the curves
     (auto-completion) with a static two-speaker mix: K4 must launch 10 x 20
     x (20 + 10) = 6000 times and nothing else; the written ``.ds`` must
     hold whole-frame ``ph_dur`` summing over each word to its duration (to
     the rounding of its phonemes) and finite f0 and curves, one value a
     frame; one segment again on the f32 modules from the same noise (pitch
     within 10 cents RMS, corr > 0.999; each curve within 1 % of its
     normalizer's range RMS); its seconds, K4's device ms (``torch.profiler``)
     and audio-s/s.  Then one segment under DDPM (DDIM, 100 of 1000 steps:
     3000 launches).  Then the written ``.ds`` through the LYNXNet acoustic
     runner of phase 6 with every optional input on (the four curve
     embeddings, a dynamic two-speaker mix, a ``gender`` curve, a
     ``velocity`` curve): a finite wav of frames*hop samples a segment, K1,
     K2 and K6 launching as in phase 6, and every segment's mel against the
     runner's f32 module path from the same noise at the bars of
     ``bench/check.py``;
  8. vocoder copy-synthesis (``inference/val_vocoder.copy_synthesis`` on the
     card) with the random full-width vocoder of phase 6, on two files: the
     wav phase 6 rendered from the sample ``.ds`` and a synthetic 2048-frame
     (23.8 s) harmonic tone with vibrato around 220 Hz and noise at -40 dB,
     written at 22.05 kHz so that loading resamples it.  Each output wav must
     be finite with frames*hop samples, K3 must launch once per file, K2
     twice and K6 27 times per file; each file's K3-scored mel MAE must
     agree with the same pair scored through K3's plain version within
     1e-4, and the synthetic clip's tracked f0 must be within 50 cents RMSE
     of its known curve, with voicing agreement > 0.9.  Per-file stage
     times are printed;
  9. the sampler sweep (``tools/perf_sweep.py``, the cell lynx_variants):
     the shipped LYNXNet 1024 x 6 with random weights, B=4, T=2048, 50
     Euler steps from T_start 0.4, in every mode (module, v1, v2, v3,
     hybrid), with the launch counters zeroed just before each mode's call
     and read just after: v1 must launch K1, v2 K5, v3 K7 and hybrid K8
     6 x 50 = 300 times, and nothing else; the module mode none.  The
     denormed mel of v2, v3 and hybrid must agree with v1's within 5 % of
     its scale, corr > 0.999 (the module mode's is recorded).  Then ms per
     step for each mode.
 10. the vocoder sweep (``tools/perf_sweep.py vocoder``, the cell
     vocoder_variants): the shipped NSF-HiFiGAN with random weights, a mel
     ~ N(0, 1) [4, 2048, 128] and f0 = 220 Hz, in the folded layout at each
     ``pallas_stages`` config (), (1,), (0,), (0, 1), (0, 1, 2), with the
     launch counters zeroed just before each config's call and read just
     after: K2 must launch len(stages) times and K6 9 x (5 - len(stages))
     times, and nothing else.  Each config's wav must agree with ()'s within
     2e-2, corr > 0.999.  The stock layout on the same weights and inputs
     (K2 twice, no K6) must agree with (0, 1)'s at corr > 0.99.  Then ms per
     call and audio-s/s of each.
 11. the bench (``python -m xiaoicesing_io_tpu_torch.bench --runs 1``) in a
     process of its own: every cell of ``BENCHMARK.json`` with its checks and
     traced window, and the WaveNet margin line; it must exit 0 and end with
     its headline.  Its wall time is printed.
 12. (after phase 8, on the experiments of phases 6 and 7b) evaluation over
     binarized sets built from the sample ``.ds`` (10 items, written with
     the port's ``IndexedDatasetBuilder``): ``evaluate_acoustic`` with
     PESQ* on the LYNXNet experiment, each item's ground-truth mel the
     runner's f32 module path from the evaluation's own seed, must launch
     K1 6 x 20 and K2 and K6 three vocoder calls' worth (prediction, ground
     truth, aux) an item and nothing else; each item's mel within the bars
     of ``bench/check.py`` of its ground truth, every reported number
     finite, and one item run again with ``pad_frames_to`` (its collated
     length grown to the runner's bucket) must give the same PESQ* within
     1e-6.  ``evaluate_variance`` on the variance experiment, the set's
     pitch the f32 modules' sample from the evaluation's own noise, must
     launch K4 20 x 20 an item (the pitch head) and nothing else, with
     ``pitch_acc`` >= 0.999, its sampled pitch within 10 cents RMS of the
     set's f32 pitch over every real frame, and the duration figures in
     [0, 1].  Then the
     DDSP wrapper on the card against the CPU (a TorchScript stand-in).
     Each evaluation's seconds and items/s are printed.
 13. (after phase 12, with the vocoder of phase 6) training on the card,
     through ``training/tasks.py``'s trainers with a recording writer, on
     synthetic binarized sets (64 train and 4 valid items of 400-1300
     frames, written with the port's ``IndexedDatasetBuilder``).  The
     shipped acoustic configuration (LYNXNet 1024 x 6, bf16-mixed,
     ``max_batch_frames`` 50000, ``max_batch_size`` 64) takes 30 updates,
     validating at 15 and 30 with 2 plots: every loss finite; the 4 valid
     items' loss from fixed t and noise in eval mode lower after than
     before; exactly 2 x 2 x 20 x 6 K1 launches and K2 and K6 six vocoder
     calls' worth (4 predictions, 2 ground truths), nothing else; every
     logged wav finite and frames x hop long; the last checkpoint loaded by
     ``DiffSingerAcousticInfer(device="cuda")``, whose ``forward_model`` on
     the last plotted item with the extras' seed must give the extras' mel
     within 1e-5 of its scale; a second trainer with two more updates must
     resume at step 30 in the saved epoch.  Then one full-width acoustic
     step at B=2, T=256 from the same weights, batch, t and noise on the
     card against the CPU in f32: in f32 the losses within 1e-4 relative
     and each gradient tensor within 1e-3 of its largest CPU value, in
     bf16-mixed the losses within 2 % and the global gradient cosine above
     0.99.  Then the shipped variance configuration with energy and
     breathiness takes 10 updates, validating at 5 and 10 with 2 plots:
     exactly 2 x 2 x 20 x (20 + 10) K4 launches and nothing else,
     ``rhythm_corr``, ``ph_dur_acc`` and ``pitch_acc`` in [0, 1].  Each leg
     prints its ms per update (the median after the first 3 updates, on
     the card's timeline, leaving out those after a validation), trained
     audio-s/s over real frames, peak memory and each validation's wall
     time.
 14. (after phase 13) binarization, ``binarize``'s binarizers on a
     synthetic raw set: two speakers, 12 sung phrases of 3-8 s at 44.1 kHz
     (harmonic tones along random notes with vibrato and -40 dB noise) over
     every phone of ``dictionaries/opencpop-extension.txt``, with
     ``ph_num``, ``note_seq`` and ``note_dur``.  The acoustic binarizer at the
     shipped settings (``pe: parselmouth``, ``hnsep: world``) with energy,
     breathiness, voicing and tension and both augmentations (random pitch
     shifting, random time stretching): every item finite, its frame arrays
     of one length, augmented items written, the set read back through
     ``AcousticDataset`` and one batch collated.  The variance binarizer with
     ``pe: rmvpe`` and ``hnsep: vr`` on random nets under the reference
     names (``E2E0()`` at its defaults; a stereo ``CascadedNet``, ``nout``
     32, ``nout_lstm`` 128, ``n_fft`` 2048, hop 512 in its ``config.yaml``),
     which run on the card: every item finite.  Each binarization runs with
     the launch counters zeroed just before it and read just after: every
     kernel 0 (binarization launches none; each kernel's
     ``binarize_path_launches``).  Then RMVPE's salience and the VR mask of
     the shortest item on the card against the same modules on the CPU
     (f32, TF32 off; tolerance 1e-4 absolute).  Each binarization prints its
     raw and written items per second, the seconds of each stage (load,
     mel, pitch, separation, curves, augmentation, write) and the card's
     peak memory.
 15. (after phase 7, on the experiments of phases 6 and 7) serving: the
     sample ``.ds`` through ``run_inference(data_parallel=True)``
     (``inference/serving.py``: segments stacked by 256-frame bucket, each
     chunk one synthesis call, the vocoder one call a distinct length) on
     each experiment, with the launch counters zeroed just before each call
     and read just after: K1 (LYNXNet) or K4 (WaveNet) once per layer per
     step per chunk, K2 twice and K6 27 times per length group, nothing else
     (each kernel's ``serve_path_launches``, the two runs summed).  Each
     segment's mel must be within ``bench/check.py``'s bars of the segment
     run alone through ``forward_model`` on the kernel path from the same
     noise row; each wav finite and frames x hop long, the song its segments
     placed; each wav of ``vocode`` (seed None, K2 and K6 at B > 1 off the
     tile) within the wav bar of its mel vocoded alone, and each K2 and K6
     launch of a group of 2-4 rows bit for bit its rows' launches alone.
     The synchronising CUDA calls of ``synthesize_mels``
     (``torch.cuda.set_sync_debug_mode``) are printed by source line.  Then
     K1 and K4 at the largest chunk serving sends them (64 x 768 frames)
     against their plain versions; then ``samples/02_一半一半.ds`` (58
     segments) on the LYNXNet experiment, serial and ``data_parallel=True``
     in turns after a warm-up of dp (audio-s/s, chunks, vocoder calls, peak
     memory, each run's host seconds by stage) and its ``vocode`` groups
     (up to 20 rows) checked as above; then
     ``deployment/benchmarks.py``'s ``bench_acoustic``
     (on the phase 6 configuration) and ``bench_vocoder`` at their defaults
     (ms per run).
 16. (after phase 7b, on the experiments of phases 6 and 7b) export: the
     port's exporters (``deployment/export.py``, on the CPU in f32, through
     its aten -> ONNX converter) write phase 6's vocoder, its LYNXNet
     experiment and phase 7b's variance experiment; each graph's seconds,
     MB and node count are printed.  The numpy executor (``onnx_run.py``)
     runs ``nsf_hifigan.onnx`` on a 256-frame mel and f0 of the sample's
     first segment, held against the card's folded vocoder (K2 twice, K6 27
     times) at ``bench/check.py``'s wav bar; the merged ``acoustic.onnx`` at
     the shipped depth and 4 Euler steps on that segment's first 64 tokens
     and 512 frames, held against the card's K1 path (24 launches) from the
     executor's start noise at the mel bars; the merged ``pitch.onnx`` at 20
     steps, held against the card's pitch head on K4 (400 launches) from
     the same noise at phase 7b's bar (10 cents RMS, corr > 0.999).  Each
     executor run's host seconds are printed.
 17. (after phase 13, on its two experiments) the JAX-checkpoint bridge
     (``training/jax_bridge.py``).  A GPU host with PyTorch alone has no
     ``tensorstore``, so the phase starts from the tree: phase 13's last
     acoustic checkpoint (LYNXNet 1024 x 6, after the resumed updates) and
     its last variance checkpoint, each as the JAX package's ``{"params",
     "opt_state"}`` tree (``jax_tree_from_state``: the port's
     ``torch_ckpt`` for the params, optax's state in the layout the
     configuration gives), converted back (``convert_jax_tree``:
     ``model_from_jax`` with its round-trip check,
     ``optimizer_state_from_jax``) into a ``.ckpt``, whose weights and
     AdamW state must be the original's bit for bit; each conversion's
     seconds are printed with the card's name and power limit.  Then
     ``DiffSingerAcousticInfer(device="cuda")`` from each file on the
     sample's first segment, seed 0: mel and wav bit for bit, K1 once per
     layer per step, K2 twice and K6 27 times, nothing else; the variance
     heads from each file on that segment's bare score: durations, pitch
     and curves bit for bit, K4 once per layer per step of both heads,
     nothing else.  Then two updates from each file with the same fixed
     gradients on the card: the parameters bit for bit equal.
 18. several cards (``parallel/mesh.py``).  (c), after phase 15 on its two
     experiments: the sample ``.ds`` through ``run_inference(
     data_parallel=True)`` with ``devices`` every visible card, then
     ``[cuda:0, cuda:0]`` (each chunk padded to a multiple of the devices
     and cut into one slice a device), the launch counters zeroed just
     before each run and read just after: K1 (LYNXNet) or K4 (WaveNet)
     exactly ``n_dev`` x phase 15's count, K2 and K6 phase 15's, nothing
     else; every segment's mel within ``bench/check.py``'s bars of the
     one-device run at the same seed, the largest difference printed; then
     ``samples/02_一半一半.ds`` with one and two replicas on the card
     (audio-s/s, no speed claim).  (a) and (b), after phase 17 on phase 13's
     sets: (a) two ranks spawned on the one card under ``gloo`` (NCCL takes
     one card a rank), each through ``Trainer``'s sampler, shape agreement
     and train step, two updates of the shipped acoustic configuration
     (LYNXNet 1024 x 6) and of the variance one at about 12,000 real frames
     a rank, f32, TF32 off, dropout 0: the ranks' parameters and gradients
     bit for bit equal, the first update's gradients within 1e-3 of each
     tensor's scale of one process's step on the concatenated batches, no
     kernel launched; each process's ms per update and peak memory.  Where
     the machine has two or more cards (a) runs again under NCCL, one card a
     rank; otherwise a line says why not.  (b) ``Trainer.fit`` of the
     shipped acoustic configuration (4 updates, validating at 2 and 4 with
     2 plots, deterministic algorithms) in a process of its own in an NCCL
     group of one rank (its all-reduce, broadcast and barrier run first)
     and in another in no group: every parameter bit for bit equal, K1, K2
     and K6 launching as phase 13's acoustic leg predicts for that run.
     Each line carries the card's name and power limit.  ``python3
     chip_smoke.py --dp-only`` runs phase 18 alone after the build, on the
     experiments and sets made afresh (for a machine of several cards: (a)
     under NCCL across all of them, (c) over all of them); it prints no
     kernels line.
 19. (after phase 5d, before phase 6) the alignment ops of ``ops/seq.py``
     on ``cuda:0`` at the sample ``.ds``'s sizes: its segments as one
     padded batch of durations, rounded from ``ph_dur`` as the acoustic
     runner rounds them.  ``length_regulator`` without ``alpha`` and at
     ``alpha`` 0.5 and 1.5 (products on .5 ties), ``mel2ph_to_dur`` without
     ``max_dur`` and clipped below the longest count, and
     ``stretch_regulator``, each on card tensors against the same call on
     the CPU: the integer outputs equal, ``stretch_regulator`` within 1e-6;
     without ``max_dur`` the counts must give back the durations.

Phase 5d (after phase 5c, so ``--kernels-only`` covers it) holds K6
``resblock_unit`` against its plain version on the folded stage-2 unit with
the widest taps (k 11, d 5: 27 + 7 folded taps, 17 + 7 of them not all
zero, L = 128) at B=4 x 131072 rows, a raw dilated unit at L = 256 (k 11,
d 5, 16384 rows a sequence) and
a folded unit at a T off the kernel's 128-row tile; then it times the 45
ResBlock1 units of one random full-width folded generator at B=4, T=2048,
stage by stage, against the plain version, the unfused cuDNN bf16 chain
(the folded layout's arithmetic in the JAX package) and ``gemm_library_ms``
(each conv's kept taps as one cuBLAS product); then the host microseconds
per call and the device split of the 27 units' leaky-ReLU passes, first and
second convs.  K6's ``ms``, ``plain_ms``, ``bound_ms`` and
``gemm_library_ms`` are the sums over the 27 units of stages 2-4, which the
wrapper's default sends to K6.

Phase 5c (after phase 5b, so ``--kernels-only`` covers it) holds K5
``lynx_layer_fused`` and K7 ``lynx_layer_fused_v3`` (both on the GEMM core,
K7's products on its persistent entry) against their plain version at four
edge shapes (fewer tiles than SMs, a ragged last row tile, dim 1536 and dim
2048 with inner 4096) and at B=4, T=2048, dim 1024, inner 2048, k 31; at the
latter each one's time, ``gemm_library_ms`` (the layer's two products as
cuBLAS bf16 products alone), host microseconds per call and the device
split of its four launches (LayerNorm, SwiGLU product, conv, output
product), then K7's two products beside K5's.  Then K8 ``conv_tail`` (on
the GEMM core too, since its redesign) against its plain version on the
PyTorch head's output at the same four edge shapes and at the sweep's shape
(the head's output for the same ``x``); at the latter its time, the head's,
``gemm_library_ms`` (its output product ``act @ w2`` as one cuBLAS bf16
product), host microseconds per call and the device split of its two
launches (conv, output product).

Phase 5b (after phase 5, so ``--kernels-only`` covers it) holds K3
``mel_spectrogram`` at the shipped ``MelConfig`` (44.1 kHz, n_fft = win 2048,
hop 512, 128 Slaney mels) against its plain version (the f32 matrix-product
DFT, TF32 off) within 2e-3 nats and against the host path (numpy, f64 FFT)
within 1e-3 nats over the true frames less the last 2 (bucket padding
changes the reflected tail), at B=4 x 2048 frames of uniform noise in
[-0.5, 0.5] and at B=2 with an off-bucket length; shapes must be equal.
Its ``library_ms`` is ``torch.stft`` (cuFFT) + the dense mel product + log on
the same input, timed here only.  Then, at the timed shape, K3's host
microseconds per call and its per-phase split (``[K3 split]``: copies of
``csrc/mel_spec.cu`` cut after each of its phases, built beside the kernels
and timed in turns with it).

Tolerance of a kernel against its plain version (same inputs, bf16 products,
TF32 off): max |kernel - plain| <= 0.02 * max |plain| and correlation >
0.9999.  K1 and K2 differ from their plain versions by f32 summation order
and the bf16 rounding of intermediates that the order flips, about one bf16
ulp (0.4 %) on a few elements; K4's plain version is the unfused bf16 chain,
which also rounds the conv output to bf16 before the gating.  The bf16 kernel
path against the f32 reference, which compounds bf16 rounding over the
layers and steps, is held to the bars of ``bench/check.py``.

Since the redesign of K1 and K4 on the Hopper GEMM core, phases 3 and 5
also cover the edge shapes above and print ``gemm_library_ms``, the host
cost per call and the per-pass device split; since that of K2 and K6 on the
same core, phases 4 and 5d do too, and since that of K5, K7 and K8, phase 5c.
The entries of K1, K2, K4, K5, K6, K7 and K8 in the kernels line carry
``gemm_library_ms`` and ``host_us`` (K2's and K6's also ``cudnn_bf16_ms``);
K3's carries ``host_us``.
Phases 6 and 7 print the device's busy share of one batch call (the bench's
traced window, ``bench/trace.py``) and phase 9
that of the ``module``, ``v1``, ``v2`` and ``v3`` sweep calls: the kernel
time of one call in a device-only ``torch.profiler`` window over the host
time of the same work.

Any failure raises: the script exits non-zero and prints no result.  The
line before the last lists the kernels as JSON (``ms``, ``plain_ms`` and
``bound_ms`` at the phase 3-5 shapes; K2's are the sum of its two stage
calls, K4's the mean over its four dilations, K6's the sum over the 27
units of stages 2-4; ``launches`` are wrapper calls in the ``.ds`` run of
the configuration that runs the kernel: phase 6 for K1, K2 and K6, phase 7
for K4 (its ``variance_path_launches`` from phase 7b); phase 8 for K3; phase 9, in the mode that runs it, for K5, K7 and
K8; K1, K2, K4 and K6 also carry ``eval_path_launches`` from phase 12;
every entry carries ``serve_path_launches`` from phase 15 and
``export_check_launches`` from phase 16; K1, K2, K4 and K6 also
``bridge_check_launches``, the converted checkpoints' runs of phase 17;
every entry ``dp_serve_launches``, phase 18 (c)'s four runs summed, and
``dp_train_launches``, phase 18 (b)'s run in the NCCL group).
The last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
HBM_BYTES = 3.35e12   # H100 SXM HBM3 bandwidth
TOL_REL = 0.02
TOL_CORR = 0.9999

B_TIME, T_TIME = 4, 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, rounds: int = 3) -> float:
    """Device ms per call of ``fn``: ``reps`` calls back to back between two
    events, the median of ``rounds`` such rounds (a host stall inside one
    round idles the device and would count as kernel time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def compare(name: str, got, ref) -> float:
    import torch

    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    corr = torch.corrcoef(torch.stack([got.flatten(), ref.flatten()]))[0, 1].item()
    log(f"[check] {name}: max_abs_err={err:.6g} max_abs_ref={scale:.6g} corr={corr:.8f} "
        f"(tolerance: err <= {TOL_REL} * max_abs_ref, corr > {TOL_CORR})")
    if not (err <= TOL_REL * scale and corr > TOL_CORR):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def bound_ms(bytes_moved: float, bf16_flops: float, f32_flops: float = 0.0):
    """The least time for the work: the largest of the bytes over the memory
    rate, the bf16 products over the tensor cores' rate and the f32 work over
    the CUDA cores' rate (separate pipes, which can overlap)."""
    t_bytes = bytes_moved / HBM_BYTES * 1e3
    t_ops = max(bf16_flops / BF16_FLOPS, f32_flops / F32_FLOPS) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def k1_inputs(B: int, T: int, dim: int = 1024, inner: int = 2048, k: int = 31, seed: int = 0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    x = rn(B, T, dim).to(torch.bfloat16)
    params = (
        1.0 + rn(dim, std=0.1), rn(dim, std=0.1),
        rn(dim, 2 * inner, std=dim ** -0.5), rn(2 * inner, std=0.05),
        rn(k, 1, inner, std=k ** -0.5), rn(inner, std=0.05),
        torch.full((inner,), 0.25, device="cuda"),
        rn(inner, dim, std=inner ** -0.5), rn(dim, std=0.05),
    )
    return x, params


def k1_bound(B, T, dim=1024, inner=2048, k=31):
    rows = B * T
    mm = 2 * rows * dim * 2 * inner + 2 * rows * inner * dim
    conv = 2 * rows * inner * k
    nbytes = rows * dim * 2 * 2 + (dim * 2 * inner + inner * dim) * 2 + (2 * dim + 5 * inner
                                                                          + k * inner) * 4
    return bound_ms(nbytes, mm, conv)


def device_split(fn, calls: int = 10) -> str:
    """Device microseconds per call of each kernel ``fn`` launches; "not
    measured" when the trace holds no device time."""
    from xiaoicesing_io_tpu_torch.bench.trace import kernel_us

    parts = kernel_us(fn, calls)
    if not parts:
        return "not measured (no device time in the trace)"
    return "; ".join(f"{name[:90]}: {us:.1f} us"
                     for name, us in sorted(parts.items(), key=lambda kv: -kv[1]))


def labelled_split(fn, labels: dict, calls: int = 3):
    """Device microseconds per call of ``fn``'s kernels summed under
    ``labels`` (label -> pieces of the kernels' names); None when the trace
    holds no device time."""
    from xiaoicesing_io_tpu_torch.bench.trace import kernel_us

    parts = kernel_us(fn, calls)
    if not parts:
        return None
    out = {label: 0.0 for label in labels}
    for name, us in parts.items():
        label = next((k for k, pieces in labels.items() if any(p in name for p in pieces)),
                     "other")
        out[label] = out.get(label, 0.0) + us
    return out


def split_text(split) -> str:
    if split is None:
        return "not measured (no device time in the trace)"
    total = sum(split.values())
    return "; ".join(f"{k}: {us:.1f} us ({us / total:.3f})" for k, us in split.items())


# the launches of K2 and K6: the leaky-ReLU pass, conv 1 (bias + lrelu epilogue), conv 2
TAPCONV_PARTS = {"lrelu pass": ("lrelu_kernel",), "conv 1": ("BiasLreluBf16",),
                 "conv 2": ("ResidualBf16", "StageEpi")}


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds per call of a wrapper, the device left running: the
    enqueue alone (checks, tensor maps, allocation, the ctypes call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


# K1's edge shapes: T off the 128-row tile and the conv's 64-row block, odd and even kernels
K1_EDGES = ((1, 37, 1024, 2048, 31), (4, 2049, 1024, 2048, 32), (1, 1000, 256, 512, 3))


def check_k1(reps: int = 20) -> dict:
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1

    errs = []
    for B, T, dim, inner, k in K1_EDGES:
        x, params = k1_inputs(B, T, dim, inner, k, seed=T)
        got = K1.lynx_conv_module(x, K1.prepare_weights(*params), kernel_size=k)
        torch.cuda.synchronize()
        errs.append(compare(f"K1 lynx_conv_module [B={B},T={T},dim={dim},inner={inner},k={k}]",
                            got, K1.lynx_conv_module_plain(x, *params, kernel_size=k)))
    B, T, k = B_TIME, T_TIME, 31
    x, params = k1_inputs(B, T)
    weights = K1.prepare_weights(*params)
    got = K1.lynx_conv_module(x, weights, kernel_size=k)
    torch.cuda.synchronize()
    ref = K1.lynx_conv_module_plain(x, *params, kernel_size=k)
    errs.append(compare("K1 lynx_conv_module [B=4,T=2048,dim=1024,inner=2048,k=31]", got, ref))
    ms = cuda_ms(lambda: K1.lynx_conv_module(x, weights, kernel_size=k), reps)
    plain_ms = cuda_ms(lambda: K1.lynx_conv_module_plain(x, *params, kernel_size=k), 3)
    # the yardstick of the GEMM core: the module's two products as cuBLAS bf16 products
    xn, act = x.reshape(B * T, -1), torch.zeros(B * T, 2048, dtype=torch.bfloat16, device="cuda")
    w_in, w2 = weights[2], weights[7]
    gemm_ms = cuda_ms(lambda: (torch.matmul(xn, w_in), torch.matmul(act, w2)), reps)
    us = host_us(lambda: K1.lynx_conv_module(x, weights, kernel_size=k))
    log(f"[K1 split] {device_split(lambda: K1.lynx_conv_module(x, weights, kernel_size=k))}")
    bms, by = k1_bound(B, T)
    log(f"[K1] ms={ms:.4f} plain_ms={plain_ms:.4f} gemm_library_ms={gemm_ms:.4f} "
        f"bound_ms={bms:.4f} ({by}) share_of_bound={bms / ms:.3f} host_us_per_call={us:.1f}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "gemm_library_ms": gemm_ms, "host_us": us}


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def k2_inputs(B: int, T: int, L: int, seed: int = 0):
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda.hifigan_stage import ConvSpec

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T, L, generator=g, device="cuda").to(torch.bfloat16)
    weights, biases, specs = [], [], []
    for k, dils in zip((3, 7, 11), ((1, 3, 5),) * 3):
        branch = []
        for d in dils:
            pair = []
            for dd in (d, 1):
                w = torch.randn(L, k * L, generator=g, device="cuda") * (0.5 / math.sqrt(k * L))
                weights.append(w.to(torch.bfloat16).contiguous())
                biases.append(torch.randn(L, generator=g, device="cuda") * 0.05)
                pair.append(ConvSpec(k=k, d=dd, pad_l=(k - 1) * dd // 2))
            branch.append(tuple(pair))
        specs.append(tuple(branch))
    return x, tuple(weights), tuple(biases), tuple(specs)


def k2_bound(B, T, L, specs):
    rows = B * T
    taps = sum(s.k for branch in specs for pair in branch for s in pair)
    mm = 2 * rows * L * L * taps
    nbytes = rows * L * 2 * 2 + taps * L * L * 2 + len(specs) * 6 * L * 4
    return bound_ms(nbytes, mm)


def products(a, weights) -> None:
    """``a @ w`` for each ``w`` (cuBLAS), each output dropped before the next."""
    import torch

    for w in weights:
        torch.matmul(a, w)


def cudnn_bf16_stage(x, convs, biases, specs):
    """The stage as unfused bf16 cuDNN convolutions (each conv's output, the
    residual stream and the branch sum in bf16), timed beside K2; ``convs``
    are ``[C_out, C_in, k]`` bf16, ``biases`` bf16."""
    import torch.nn.functional as F

    acc, ci = None, 0
    for branch in specs:
        h = x
        for pair in branch:
            t = h
            for s in pair:
                t = F.leaky_relu(t, 0.1).transpose(1, 2)
                t = F.conv1d(F.pad(t, (s.pad_l, (s.k - 1) * s.d - s.pad_l)), convs[ci],
                             dilation=s.d).transpose(1, 2) + biases[ci]
                ci += 1
            h = h + t
        acc = h if acc is None else acc + h
    return acc / len(specs)


K2_OFF_TILE_FRAMES = 873  # a mel length whose stage rows are no multiple of a tile


def check_k2(reps: int = 3) -> dict:
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2

    total = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "stage_ms": [],
             "gemm_library_ms": 0.0, "cudnn_bf16_ms": 0.0, "host_us": 0.0}
    by = "operations"
    for stage, (T, L) in enumerate(((T_TIME * 8, 256), (T_TIME * 64, 128))):
        x, w, b, specs = k2_inputs(B_TIME, T, L, seed=stage)
        got = K2.fused_resblock_stage(x, w, b, specs)
        torch.cuda.synchronize()
        ref = K2.fused_resblock_stage_plain(x, w, b, specs)
        err = compare(f"K2 fused_resblock_stage stage {stage} [B={B_TIME},T={T},L={L}]", got, ref)
        del got, ref
        ms = cuda_ms(lambda: K2.fused_resblock_stage(x, w, b, specs), reps)
        plain_ms = cuda_ms(lambda: K2.fused_resblock_stage_plain(x, w, b, specs), 1)
        ks = [s.k for branch in specs for pair in branch for s in pair]
        convs = [K2.unstack_taps(wi, k).permute(2, 1, 0).contiguous() for wi, k in zip(w, ks)]
        b16 = [bi.to(x.dtype) for bi in b]
        cudnn_ms = cuda_ms(lambda: cudnn_bf16_stage(x, convs, b16, specs), reps)
        # the yardstick of the GEMM core: each conv's taps as one cuBLAS product [rows, L] @ [L, kL]
        rows = x.reshape(-1, L)
        gemm_ms = cuda_ms(lambda: products(rows, w), reps)
        us = host_us(lambda: K2.fused_resblock_stage(x, w, b, specs), calls=20)
        split = labelled_split(lambda: K2.fused_resblock_stage(x, w, b, specs), TAPCONV_PARTS)
        bms, by_s = k2_bound(B_TIME, T, L, specs)
        log(f"[K2 stage {stage}] ms={ms:.4f} plain_ms={plain_ms:.4f} cudnn_bf16_ms={cudnn_ms:.4f} "
            f"gemm_library_ms={gemm_ms:.4f} bound_ms={bms:.4f} ({by_s}) "
            f"share_of_bound={bms / ms:.3f} host_us_per_call={us:.1f}")
        log(f"[K2 stage {stage} split] {split_text(split)}")
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["stage_ms"].append(ms)
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bms),
                       ("gemm_library_ms", gemm_ms), ("cudnn_bf16_ms", cudnn_ms), ("host_us", us)):
            total[key] += v
        by = by_s if by_s == "bytes" else by
        del x, w, b, b16, convs, rows
    # serving stacks equal-length mels, so the stages also run at B > 1 with T off the tile
    for stage, (T, L) in enumerate(((K2_OFF_TILE_FRAMES * 8, 256),
                                    (K2_OFF_TILE_FRAMES * 64, 128))):
        x, w, b, specs = k2_inputs(2, T, L, seed=10 + stage)
        got = K2.fused_resblock_stage(x, w, b, specs)
        torch.cuda.synchronize()
        err = compare(f"K2 fused_resblock_stage stage {stage} off the tile [B=2,T={T},L={L}]",
                      got, K2.fused_resblock_stage_plain(x, w, b, specs))
        total["max_abs_err"] = max(total["max_abs_err"], err)
        del x, w, b, got
    total["host_us"] /= 2
    log(f"[K2] stages 0 + 1: ms={total['ms']:.4f} plain_ms={total['plain_ms']:.4f} "
        f"cudnn_bf16_ms={total['cudnn_bf16_ms']:.4f} gemm_library_ms="
        f"{total['gemm_library_ms']:.4f} bound_ms={total['bound_ms']:.4f} "
        f"share_of_bound={total['bound_ms'] / total['ms']:.3f} host_us_per_call (mean of the "
        f"stages)={total['host_us']:.1f}")
    torch.cuda.empty_cache()
    return dict(total, bound_by=by)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

K4_DILATIONS = (1, 2, 4, 8)


def k4_inputs(B: int, T: int, C: int = 512, seed: int = 0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    y = rn(B, T, C, std=0.5).to(torch.bfloat16)
    cond = rn(B, T, 2 * C, std=0.5).to(torch.bfloat16)
    params = (rn(3, C, 2 * C, std=(3 * C) ** -0.5), rn(2 * C, std=0.05),
              rn(C, 2 * C, std=C ** -0.5), rn(2 * C, std=0.05))
    return y, cond, params


def k4_bound(B, T, C=512):
    rows = B * T
    mm = 4 * 2 * rows * C * 2 * C
    nbytes = rows * C * 2 + 2 * rows * 2 * C * 2 + 4 * C * 2 * C * 2 + 2 * 2 * C * 4
    return bound_ms(nbytes, mm)


# K4's edge shapes: T off the tile, a reach past a whole tile, the variance widths
K4_EDGES = ((2, 2049, 512, 64), (1, 100, 192, 16), (4, 2048, 256, 8))


def check_k4(reps: int = 20) -> dict:
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import wavenet_block as K4

    errs, times, plain_times = [], [], []
    for B, T, C, d in K4_EDGES:
        y, cond, params = k4_inputs(B, T, C, seed=T + d)
        got = K4.wavenet_block(y, cond, K4.prepare_weights(*params), dilation=d)
        torch.cuda.synchronize()
        errs.append(compare(f"K4 wavenet_block [B={B},T={T},C={C},d={d}]", got,
                            K4.wavenet_block_plain(y, cond, *params, dilation=d)))
    B, T = B_TIME, T_TIME
    y, cond, params = k4_inputs(B, T)
    weights = K4.prepare_weights(*params)
    bms, by = k4_bound(B, T)
    for d in K4_DILATIONS:
        got = K4.wavenet_block(y, cond, weights, dilation=d)
        torch.cuda.synchronize()
        ref = K4.wavenet_block_plain(y, cond, *params, dilation=d)
        errs.append(compare(f"K4 wavenet_block [B={B},T={T},C=512,d={d}]", got, ref))
        del got, ref
        times.append(cuda_ms(lambda: K4.wavenet_block(y, cond, weights, dilation=d), reps))
        plain_times.append(cuda_ms(lambda: K4.wavenet_block_plain(y, cond, *params, dilation=d),
                                   reps))
        log(f"[K4 d={d}] ms={times[-1]:.4f} plain_ms={plain_times[-1]:.4f} bound_ms={bms:.4f} "
            f"({by}) share_of_bound={bms / times[-1]:.3f}")
    # the yardstick of the GEMM core: the three tap products and the output product as cuBLAS
    # bf16 products at C = 512
    rows = y.reshape(B * T, -1)
    taps, w_out = weights[0], weights[2]
    gemm_ms = cuda_ms(lambda: [torch.matmul(rows, w) for w in (taps[0], taps[1], taps[2], w_out)],
                      reps)
    us = host_us(lambda: K4.wavenet_block(y, cond, weights, dilation=1))
    log(f"[K4 split] d=1: {device_split(lambda: K4.wavenet_block(y, cond, weights, dilation=1))}")
    ms = sum(times) / len(times)
    log(f"[K4] ms={ms:.4f} (mean of d = {K4_DILATIONS}) gemm_library_ms={gemm_ms:.4f} "
        f"bound_ms={bms:.4f} share_of_bound={bms / ms:.3f} host_us_per_call={us:.1f}")
    del y, cond, weights, rows
    variance = check_k4_variance_widths(reps)
    errs += [row["max_abs_err"] for row in variance]
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": sum(plain_times) / len(plain_times),
            "bound_ms": bms, "bound_by": by, "gemm_library_ms": gemm_ms, "host_us": us,
            "variance_widths": variance}


# K4 at the variance model's heads: the pitch head (C 256, d up to 16) and the multi-variance
# head (C 192, d up to 8), one sequence of a 256-frame bucket and of 1024 frames (a segment of
# the sample song)
K4_VARIANCE = tuple((1, T, C, d) for C in (256, 192) for T in (256, 1024) for d in (16, 8))


def check_k4_variance_widths(reps: int) -> list:
    """K4 against its plain version at :data:`K4_VARIANCE`; each shape's
    time beside its plain version's, ``gemm_library_ms`` (its four products
    as cuBLAS bf16 products) and its bound.  At these sizes a launch's
    device time is below the wrapper's host time, so back-to-back calls time
    the host: ``device_ms`` is the kernels' device time alone (a
    ``torch.profiler`` window)."""
    import torch

    from xiaoicesing_io_tpu_torch.bench.trace import kernel_us
    from xiaoicesing_io_tpu_torch.ops.cuda import wavenet_block as K4

    out = []
    for B, T, C, d in K4_VARIANCE:
        y, cond, params = k4_inputs(B, T, C, seed=C + T + d)
        weights = K4.prepare_weights(*params)
        got = K4.wavenet_block(y, cond, weights, dilation=d)
        torch.cuda.synchronize()
        err = compare(f"K4 wavenet_block [B={B},T={T},C={C},d={d}]", got,
                      K4.wavenet_block_plain(y, cond, *params, dilation=d))
        ms = cuda_ms(lambda: K4.wavenet_block(y, cond, weights, dilation=d), reps)
        plain = cuda_ms(lambda: K4.wavenet_block_plain(y, cond, *params, dilation=d), reps)
        rows, taps, w_out = y.reshape(B * T, C), weights[0], weights[2]
        gemm = cuda_ms(lambda: [torch.matmul(rows, w) for w in (taps[0], taps[1], taps[2], w_out)],
                       reps)
        bms, by = k4_bound(B, T, C)
        dev = sum(kernel_us(lambda: K4.wavenet_block(y, cond, weights, dilation=d),
                            reps).values()) / 1e3 or None
        log(f"[K4 variance width] B={B} T={T} C={C} d={d}: ms={ms:.4f} device_ms="
            + (f"{dev:.4f}" if dev else "not measured")
            + f" plain_ms={plain:.4f} gemm_library_ms={gemm:.4f} bound_ms={bms:.4f} ({by}) "
            f"share_of_bound={bms / (dev or ms):.3f}")
        out.append({"B": B, "T": T, "C": C, "d": d, "max_abs_err": err, "ms": ms,
                    "device_ms": dev, "plain_ms": plain, "gemm_library_ms": gemm,
                    "bound_ms": bms})
    return out


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

K3_TOL_PLAIN = 2e-3   # nats, kernel vs the f32 matrix-product DFT
K3_TOL_NUMPY = 1e-3   # nats, kernel vs the host path (f64 FFT)
K3_FRAMES = 2048


def k3_bound(prep, B: int, T: int):
    """A real FFT (2.5 n log2 n), the sparse mel projection (2 per weight) and
    the magnitudes (~3 per bin used) per frame, against the waveform read
    once and the log-mel written once."""
    frames = B * prep.num_frames(T)
    flop = frames * (2.5 * prep.n_fft * math.log2(prep.n_fft) + 2 * prep.nnz + 3 * prep.n_bins)
    nbytes = B * T * 4 + frames * prep.n_mels * 4
    return bound_ms(nbytes, 0.0, flop)


# K3's phases, in the order its source marks them; a copy of the source cut at a marker ends the
# kernel there, writing what the last kept phase left (the frame's samples or the planes' first
# words) so that nothing before it is optimised away
K3_PHASES = (("staging", "  // 1. lane n1", "x[m]"), ("step 1", "  // 2.-3. lane k2", "re[m]"),
             ("step 3", "  // 4. the real split", "re[m]"),
             ("real split", "  // 5. sparse mel", "re[m]"))


def k3_phase_split(prep, y, reps: int = 20) -> dict:
    """Device microseconds of each of K3's phases (staging, step 1, step 3,
    real split, mel projection) at ``y``'s shape: copies of
    ``csrc/mel_spec.cu`` cut after each phase, built beside the kernels and
    timed in turns with the whole kernel; a phase is the difference of two
    cuts' times."""
    import ctypes

    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import build
    from xiaoicesing_io_tpu_torch.ops.cuda import mel_spec as K3

    src = (build.CSRC / "mel_spec.cu").read_text()
    end = src.index("\ntemplate <int N1, int N2>\ncudaError_t launch")
    work = build.BUILD_DIR / "mel_phases"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, marker, kept in K3_PHASES:
        cut = src[:src.index(marker)] + (
            "  __syncwarp();\n  float* ob = out + (static_cast<size_t>(b) * n_frames + f0 + warp)"
            f" * n_mels;\n  for (int m = lane; m < n_mels; m += 32) ob[m] = {kept};\n}}\n"
        ) + src[end:]
        cu = work / f"{name.replace(' ', '_')}.cu"
        cu.write_text(cut)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def entry(lib):
        fn = lib.mel_spec_launch
        fn.argtypes, fn.restype = K3._ARGTYPES, ctypes.c_int
        return fn

    fns = {"whole": entry(build.load("mel_spec"))}
    for name, proc in procs.items():
        log_text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"K3 split: the cut after {name} did not build:\n{log_text[-2000:]}")
        fns[name] = entry(ctypes.CDLL(str(work / f"{name.replace(' ', '_')}.so")))
    out = torch.empty(y.shape[0], prep.num_frames(y.shape[1]), prep.n_mels, device=y.device)
    args = K3.launch_args(y, prep, out)
    order = [name for name, _, _ in K3_PHASES] + ["whole"]
    ms = {name: [] for name in order}
    for rnd in range(2):  # in turns, forward then backward
        for name in (order if rnd == 0 else order[::-1]):
            ms[name].append(cuda_ms(lambda fn=fns[name]: build.check(fn(*args), "K3 split"), reps))
    t = {name: sum(v) / len(v) * 1e3 for name, v in ms.items()}
    split = {"staging": t["staging"]}
    for (prev, _, _), (name, _, _) in zip(K3_PHASES, K3_PHASES[1:]):
        split[name] = t[name] - t[prev]
    split["mel projection"] = t["whole"] - t["real split"]
    return split


def check_k3(reps: int = 20) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from xiaoicesing_io_tpu_torch.ops.cuda import mel_spec as K3
    from xiaoicesing_io_tpu_torch.ops.mel import MelConfig, MelSpectrogram, num_frames

    cfg = MelConfig()
    ext = MelSpectrogram(cfg)
    prep = ext.prepared("cuda")
    rng = np.random.default_rng(0)
    errs = []
    for B, T in ((B_TIME, K3_FRAMES * cfg.hop_size), (2, 3 * cfg.hop_size * 100 + 77)):
        y_np = rng.uniform(-0.5, 0.5, (B, T)).astype(np.float32)
        y = torch.from_numpy(y_np).cuda()
        got = ext.device(y)
        torch.cuda.synchronize()
        plain = ext.device(y, plain=True)
        ref = ext.numpy(y_np)
        n = num_frames(T, cfg.win_size, cfg.hop_size)
        if not (got.shape == plain.shape and ref.shape == (B, n, cfg.n_mels)
                and got.shape[1] >= n and torch.isfinite(got).all()):
            raise AssertionError(f"K3 shapes: kernel {tuple(got.shape)}, plain "
                                 f"{tuple(plain.shape)}, host {ref.shape}")
        err_plain = (got - plain).abs().max().item()
        err_np = float(np.abs(got[:, : n - 2].cpu().numpy() - ref[:, : n - 2]).max())
        log(f"[check] K3 mel_spectrogram [B={B},T={T},{n} frames, {got.shape[1]} bucketed]: "
            f"max_abs_err vs plain={err_plain:.6g} (tolerance {K3_TOL_PLAIN}), vs host "
            f"numpy={err_np:.6g} over {n - 2} frames (tolerance {K3_TOL_NUMPY}); "
            f"mel range [{got.min().item():.3f}, {got.max().item():.3f}]")
        if err_plain > K3_TOL_PLAIN or err_np > K3_TOL_NUMPY:
            raise AssertionError("K3 disagrees with its plain version or the host path")
        errs.append(err_plain)
        if B == B_TIME:
            y_time = y
    y = y_time
    window = torch.hann_window(cfg.win_size, device="cuda")
    pad_l, pad_r = prep.pad_l, prep.pad_r

    def library():
        ypad = F.pad(y[:, None], (pad_l, pad_r), mode="reflect")[:, 0]
        spec = torch.stft(ypad, cfg.n_fft, hop_length=cfg.hop_size, win_length=cfg.win_size,
                          window=window, center=False, return_complex=True).abs()
        return torch.log(torch.clamp(prep.mel_basis @ spec, min=cfg.clip_val)).transpose(1, 2)

    lib_err = (library() - K3.mel_spectrogram(y, prep)).abs().max().item()
    ms = cuda_ms(lambda: K3.mel_spectrogram(y, prep), reps)
    plain_ms = cuda_ms(lambda: ext.torch(y), 5)
    library_ms = cuda_ms(library, reps)
    bms, by = k3_bound(prep, B_TIME, y.shape[1])
    us = host_us(lambda: K3.mel_spectrogram(y, prep))
    frames, smem = K3.block_plan(prep.n_fft, prep.hop_size, prep.num_frames(y.shape[1]))
    log(f"[K3] ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={bms:.4f} ({by}) share_of_bound={bms / ms:.3f} host_us_per_call={us:.1f} "
        f"[B={B_TIME}, {K3_FRAMES} frames, {frames} a block, {smem} B of shared memory, FFT "
        f"{' x '.join(map(str, K3.fft_split(prep.n_fft)))}; library = torch.stft + mel product "
        f"+ log, max |library - kernel| {lib_err:.6g}]")
    log(f"[K3 split] {split_text(k3_phase_split(prep, y))} (copies of the kernel cut after "
        f"each phase, timed in turns)")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms, "host_us": us}


# ---------------------------------------------------------------------------
# K5, K7, K8: the LYNX sampler's kernel variants
# ---------------------------------------------------------------------------

def layer_bound(B, T, dim=1024, inner=2048, k=31):
    """K5 and K7: the three products and the f32 conv, against x, cond_proj
    and the output (bf16) and the weights read once."""
    rows = B * T
    mm = 2 * rows * dim * 2 * inner + 2 * rows * inner * dim
    conv = 2 * rows * inner * k
    nbytes = 3 * rows * dim * 2 + B * dim * 4 + (dim * 2 * inner + inner * dim) * 2 \
        + (2 * dim + 5 * inner + k * inner) * 4
    return bound_ms(nbytes, mm, conv)


def tail_bound(B, T, dim=1024, inner=2048, k=31):
    """K8: the [inner -> dim] product and the f32 conv, against the bf16
    inner rows, the output and the tail's weights read once."""
    rows = B * T
    nbytes = rows * inner * 2 + rows * dim * 2 + inner * dim * 2 + (3 * inner + k * inner
                                                                      + dim) * 4
    return bound_ms(nbytes, 2 * rows * inner * dim, 2 * rows * inner * k)


# K5's, K7's and K8's edge shapes: fewer tiles than SMs, a ragged last row tile, dims above the
# cap of 1024 that their WMMA versions had
LAYER_EDGES = ((1, 37, 1024, 2048, 31), (4, 2049, 1024, 2048, 31), (2, 1000, 1536, 3072, 31),
               (1, 2048, 2048, 4096, 31))
# the launches of K5 and K7: LayerNorm, the SwiGLU product, the conv, the output product
LAYER_PARTS = {"layer norm": ("layer_norm_kernel",), "SwiGLU product": ("SwigluEpi",),
               "conv": ("dwconv_prelu",), "output product": ("LayerOut",)}
# the launches of K8: the conv over the bf16 head output, the output product
TAIL_PARTS = {"conv": ("dwconv_prelu",), "output product": ("StoreBiasBf16",)}


def layer_inputs(B: int, T: int, dim: int = 1024, inner: int = 2048, k: int = 31, seed: int = 0):
    import torch

    x, params = k1_inputs(B, T, dim, inner, k, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cond = torch.randn(B, T, dim, generator=g, device="cuda").to(torch.bfloat16)
    step = torch.randn(B, dim, generator=g, device="cuda").to(torch.bfloat16).float()
    return x, cond, step, params


def check_variants(reps: int = 10) -> dict:
    """K5 and K7 against their plain version at their edge shapes and at the
    sweep's shape (B=4, T=2048, dim 1024, inner 2048, k 31), where each is
    timed with its cuBLAS products, host cost and per-pass split; K8 on the
    head's output for the same x."""
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_layer as K5

    entries = (("K5", "lynx_layer_fused", K5.lynx_layer_fused),
               ("K7", "lynx_layer_fused_v3", K5.lynx_layer_fused_v3))
    errs = {"K5": [], "K7": []}
    for B, T, dim, inner, k in LAYER_EDGES:
        x, cond, step, params = layer_inputs(B, T, dim, inner, k, seed=T + dim)
        weights = K5.prepare_layer_weights(*params)
        ref = K5.lynx_layer_fused_plain(x, cond, step, *params, kernel_size=k)
        for key, name, fn in entries:
            got = fn(x, cond, step, weights, kernel_size=k)
            torch.cuda.synchronize()
            errs[key].append(compare(f"{key} {name} [B={B},T={T},dim={dim},inner={inner},k={k}]",
                                     got, ref))
        del x, cond, weights, ref, got
    B, T, k = B_TIME, T_TIME, 31
    x, cond, step, params = layer_inputs(B, T)
    weights = K5.prepare_layer_weights(*params)
    shape = "[B=4,T=2048,dim=1024,inner=2048,k=31]"
    out = {}
    ref = K5.lynx_layer_fused_plain(x, cond, step, *params, kernel_size=k)
    for key, name, fn in entries:
        got = fn(x, cond, step, weights, kernel_size=k)
        torch.cuda.synchronize()
        errs[key].append(compare(f"{key} {name} {shape}", got, ref))
        del got
        ms = cuda_ms(lambda: fn(x, cond, step, weights, kernel_size=k), reps)
        out[key] = {"max_abs_err": max(errs[key]), "ms": ms}
    del ref
    plain_ms = cuda_ms(lambda: K5.lynx_layer_fused_plain(x, cond, step, *params, kernel_size=k),
                       3)
    # the GEMM core's yardstick: the layer's two products as cuBLAS bf16 products
    xn = x.reshape(B * T, -1)
    act = torch.zeros(B * T, weights[7].shape[0], dtype=torch.bfloat16, device="cuda")
    gemm_ms = cuda_ms(lambda: (torch.matmul(xn, weights[2]), torch.matmul(act, weights[7])), reps)
    bms, by = layer_bound(B, T)
    splits = {}
    for key, name, fn in entries:
        call = (lambda fn=fn: fn(x, cond, step, weights, kernel_size=k))
        us = host_us(call)
        splits[key] = labelled_split(call, LAYER_PARTS)
        out[key].update(plain_ms=plain_ms, bound_ms=bms, bound_by=by, gemm_library_ms=gemm_ms,
                        host_us=us)
        log(f"[{key}] ms={out[key]['ms']:.4f} plain_ms={plain_ms:.4f} "
            f"gemm_library_ms={gemm_ms:.4f} bound_ms={bms:.4f} ({by}) "
            f"share_of_bound={bms / out[key]['ms']:.3f} host_us_per_call={us:.1f}")
        log(f"[{key} split] {split_text(splits[key])}")
    if splits["K5"] is not None and splits["K7"] is not None:
        log("[K7 vs K5 products] " + "; ".join(
            f"{part}: K5 {splits['K5'][part]:.1f} us, K7 {splits['K7'][part]:.1f} us"
            for part in ("SwiGLU product", "output product")))

    out["K8"] = check_k8(x, weights, reps)
    return out


def check_k8(x, weights, reps: int) -> dict:
    """K8 ``conv_tail`` on the PyTorch head's output against its plain
    version at the edge shapes of K5 and K7, then at the sweep's shape on the
    head's output for ``x`` and ``weights``, where it is timed with its
    cuBLAS product, the head, its host cost and its per-pass split."""
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1
    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_hybrid as K8

    errs = []
    for B, T, dim, inner, k in LAYER_EDGES:
        xe, params = k1_inputs(B, T, dim, inner, k, seed=T + dim + 8)
        we = K1.prepare_weights(*params)
        head = K8.conv_head(xe, *we[:4])
        got = K8.conv_tail(head, we, kernel_size=k)
        torch.cuda.synchronize()
        errs.append(compare(f"K8 conv_tail [B={B},T={T},dim={dim},inner={inner},k={k}]", got,
                            K8.conv_tail_plain(head, *we[4:], kernel_size=k)))
        del xe, we, head, got
    B, T, k = B_TIME, T_TIME, 31
    head = K8.conv_head(x, *weights[:4])

    def call():
        return K8.conv_tail(head, weights, kernel_size=k)

    got = call()
    torch.cuda.synchronize()
    errs.append(compare("K8 conv_tail [B=4,T=2048,dim=1024,inner=2048,k=31]", got,
                        K8.conv_tail_plain(head, *weights[4:], kernel_size=k)))
    del got
    ms = cuda_ms(call, reps)
    plain_ms = cuda_ms(lambda: K8.conv_tail_plain(head, *weights[4:], kernel_size=k), 3)
    # the GEMM core's yardstick: the output product act @ w2 as one cuBLAS bf16 product
    act = torch.zeros(B * T, weights[7].shape[0], dtype=torch.bfloat16, device="cuda")
    gemm_ms = cuda_ms(lambda: torch.matmul(act, weights[7]), reps)
    bms, by = tail_bound(B, T)
    head_ms = cuda_ms(lambda: K8.conv_head(x, *weights[:4]), reps)
    us = host_us(call)
    log(f"[K8] ms={ms:.4f} plain_ms={plain_ms:.4f} gemm_library_ms={gemm_ms:.4f} "
        f"bound_ms={bms:.4f} ({by}) share_of_bound={bms / ms:.3f} host_us_per_call={us:.1f} "
        f"(the torch head before it: {head_ms:.4f} ms)")
    log(f"[K8 split] {split_text(labelled_split(call, TAIL_PARTS))}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "gemm_library_ms": gemm_ms, "host_us": us}


# ---------------------------------------------------------------------------
# K6: one ResBlock1 unit of the time-folded vocoder
# ---------------------------------------------------------------------------

def k6_unit(B: int, T: int, C: int, k: int, d: int, F: int, seed: int = 0):
    """A random unit of width C folded by F (F = 1: raw dilated taps) in the
    kernel's operand types, its geometry, and a bf16 input [B, T/F, F*C]."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_fast import fold_conv
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_resblock as K6

    rng = np.random.default_rng(seed)
    w1, w2 = (rng.standard_normal((k, C, C)) * (0.5 / math.sqrt(k * C)) for _ in range(2))
    b1, b2 = (rng.standard_normal(C) * 0.05 for _ in range(2))
    f1 = fold_conv(w1.astype(np.float32), b1.astype(np.float32), F, dilation=d)
    f2 = fold_conv(w2.astype(np.float32), b2.astype(np.float32), F)
    weights = K6.prepare_unit_weights(f1[0], f1[1], f2[0], f2[1], torch.bfloat16, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T // F, F * C, generator=g, device="cuda").to(torch.bfloat16)
    return x, weights, dict(d1=f1[3], pad1_l=f1[2], d2=f2[3], pad2_l=f2[2])


def nonzero_taps(w) -> int:
    return int((w.float().abs().amax(dim=(1, 2)) > 0).sum().item())


def k6_bound(rows: int, weights):
    """One unit: the products of its taps that are not all zero, against the
    bf16 input and output and the weights read once."""
    w1, _, w2, _ = weights
    L = w1.shape[-1]
    taps = nonzero_taps(w1) + nonzero_taps(w2)
    return 2 * rows * L * L * taps, rows * L * 2 * 2 + taps * L * L * 2 + 2 * L * 4


def cudnn_bf16_unit(x, weights, d1, pad1_l, d2, pad2_l):
    """The unit as unfused bf16 cuDNN convolutions (outputs rounded to bf16,
    bias and residual added in bf16): the folded layout's arithmetic in the
    JAX package (``nsf_fast._conv_folded``), timed beside K6."""
    import torch.nn.functional as F

    w1, b1, w2, b2 = weights
    out = x
    for w, b, d, p in ((w1, b1, d1, pad1_l), (w2, b2, d2, pad2_l)):
        k = w.shape[0]
        t = F.leaky_relu(out, 0.1).transpose(1, 2)
        t = F.conv1d(F.pad(t, (p, (k - 1) * d - p)), w.permute(2, 1, 0), dilation=d)
        out = t.transpose(1, 2) + b.to(x.dtype)
    return x + out


def kept_stacked(w):
    """The taps of ``[k, L, L]`` that are not all zero, stacked ``[L, kept L]``."""
    from xiaoicesing_io_tpu_torch.ops.cuda import sm90
    from xiaoicesing_io_tpu_torch.ops.cuda.hifigan_stage import stack_taps

    return stack_taps(w[sm90.kept_taps(w)]).contiguous()


def check_k6(reps: int = 3) -> dict:
    """Phase 5d: K6 against its plain version, then the 45 ResBlock1 units of
    a random full-width folded generator at B=4, T=2048, stage by stage."""
    import torch

    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_fast import FastNsfHifigan
    from xiaoicesing_io_tpu_torch.models.vocoders.nsf_hifigan import (
        Generator, NsfHifiganConfig,
    )
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_resblock as K6

    errs = []
    for label, shape in (
            ("folded stage 2, k11 d5 (17 of 27 + 7 taps kept), L=128",
             (B_TIME, T_TIME * 128, 64, 11, 5, 2)),
            ("raw stage 0, k11 d5, L=256", (B_TIME, T_TIME * 8, 256, 11, 5, 1)),
            ("folded stage 3, k7 d3, L=128, off-tile T", (3, 4 * 4099, 32, 7, 3, 4))):
        x, w, geometry = k6_unit(*shape, seed=len(errs))
        got = K6.resblock_unit(x, *w, **geometry)
        torch.cuda.synchronize()
        ref = K6.resblock_unit_plain(x, *w, **geometry)
        errs.append(compare(f"K6 resblock_unit {label} [B={x.shape[0]},T={x.shape[1]}]", got,
                            ref))
        del x, got, ref

    vcfg = NsfHifiganConfig()
    torch.manual_seed(0)
    fast = FastNsfHifigan(Generator(vcfg).cuda(), torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    total = {"ms": 0.0, "plain_ms": 0.0, "cudnn_ms": 0.0, "gemm_ms": 0.0, "flop": 0.0,
             "bytes": 0.0, "dense_flop": 0.0}
    stage_ms = []
    samples = T_TIME
    k6_runs = []  # (x, units) of stages 2-4, for the device split of the 27 units
    for i, (u, stage) in enumerate(zip(vcfg.upsample_rates, fast.stages)):
        samples *= u
        t = {"ms": 0.0, "plain_ms": 0.0, "cudnn_ms": 0.0, "gemm_ms": 0.0, "flop": 0.0,
             "bytes": 0.0}
        units = [unit for branch in stage["units"] for unit in branch]
        L = units[0][0][0].shape[-1]
        x = torch.randn(B_TIME, samples // stage["F"], L, generator=g, device="cuda")
        x = x.to(torch.bfloat16)
        rows = x.shape[0] * x.shape[1]
        x2d = x.reshape(rows, L)
        for weights, geometry in units:
            t["ms"] += cuda_ms(lambda: K6.resblock_unit(x, *weights, **geometry), reps)
            t["plain_ms"] += cuda_ms(lambda: K6.resblock_unit_plain(x, *weights, **geometry), 1)
            t["cudnn_ms"] += cuda_ms(lambda: cudnn_bf16_unit(x, weights, **geometry), reps)
            # the yardstick of the GEMM core: each conv's kept taps as one cuBLAS product
            kept = [kept_stacked(weights[0]), kept_stacked(weights[2])]
            t["gemm_ms"] += cuda_ms(lambda: products(x2d, kept), reps)
            del kept
            flop, nbytes = k6_bound(rows, weights)
            t["flop"] += flop
            t["bytes"] += nbytes
            if i >= 2:
                w1, _, w2, _ = weights
                total["dense_flop"] += 2 * rows * L * L * (w1.shape[0] + w2.shape[0])
        bms, by = bound_ms(t["bytes"], t["flop"])
        log(f"[K6 stage {i}] {len(units)} units, L={L}, {rows} rows: ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} cudnn_bf16_ms={t['cudnn_ms']:.4f} "
            f"gemm_library_ms={t['gemm_ms']:.4f} bound_ms={bms:.4f} ({by}) "
            f"share_of_bound={bms / t['ms']:.3f} tflop={t['flop'] / 1e12:.4f}")
        stage_ms.append(t["ms"])
        if i >= 2:  # the units the wrapper's default sends to K6
            for key in t:
                total[key] += t[key]
            k6_runs.append((x, units))
        del x, x2d

    def k6_units():
        for x, units in k6_runs:
            for weights, geometry in units:
                K6.resblock_unit(x, *weights, **geometry)

    x2, units2 = k6_runs[0]
    us = host_us(lambda: K6.resblock_unit(x2, *units2[-1][0], **units2[-1][1]))
    split = labelled_split(k6_units, TAPCONV_PARTS, calls=2)
    bms, by = bound_ms(total["bytes"], total["flop"])
    dense_ms = total["dense_flop"] / BF16_FLOPS * 1e3
    log(f"[K6] stages 2-4, 27 units: ms={total['ms']:.4f} plain_ms={total['plain_ms']:.4f} "
        f"cudnn_bf16_ms={total['cudnn_ms']:.4f} gemm_library_ms={total['gemm_ms']:.4f} "
        f"bound_ms={bms:.4f} ({by}, {total['flop'] / 1e12:.4f} TFLOP of non-zero taps, the "
        f"ones the kernel computes; {dense_ms:.4f} ms counting the all-zero folded taps too) "
        f"share_of_bound={bms / total['ms']:.3f} host_us_per_call={us:.1f}")
    log(f"[K6 split] 27 units: {split_text(split)}")
    del fast, k6_runs, x2, units2
    torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": bms, "bound_by": by, "gemm_library_ms": total["gemm_ms"],
            "cudnn_bf16_ms": total["cudnn_ms"], "host_us": us, "stage_ms": stage_ms}


SWEEP_STEPS = 50
SWEEP_MODE_KERNEL = {"v1": "lynx_conv_module", "v2": "lynx_layer_fused",
                     "v3": "lynx_layer_fused_v3", "hybrid": "lynx_conv_tail"}


def run_sampler_sweep(name_limit: str, reps: int = 2) -> dict:
    """Phase 9: the sweep's sampler at full width, every mode; the launch
    counters are zeroed just before each mode's checked call and read just
    after.  Returns the launches of each variant kernel in its mode."""
    import torch

    from xiaoicesing_io_tpu_torch.bench.check import (
        MEL_TOL_CORR, MEL_TOL_REL, corr, launch_counts, zero_launch_counts,
    )
    from xiaoicesing_io_tpu_torch.bench.trace import device_busy_ms
    from xiaoicesing_io_tpu_torch.tools import perf_sweep

    t0 = time.perf_counter()
    sweep = perf_sweep.SamplerSweep.random(device="cuda", B=B_TIME, T=T_TIME,
                                           steps=SWEEP_STEPS)
    layers = len(sweep.model.backbone.residual_layers)
    want = layers * SWEEP_STEPS
    log(f"[setup lynx_variants] shipped LYNXNet {sweep.model.backbone.num_channels} x {layers}, "
        f"random weights, B={B_TIME} T={T_TIME} {SWEEP_STEPS} Euler steps; built in "
        f"{time.perf_counter() - t0:.1f}s")
    mels, launches = {}, {}
    for mode in perf_sweep.MODES:
        zero_launch_counts()
        mel = sweep.run(mode)
        torch.cuda.synchronize()
        counts = launch_counts()
        kernel = SWEEP_MODE_KERNEL.get(mode)
        log(f"[sweep {mode}] launches {counts}; expected {kernel}: {want} "
            f"({layers} layers x {SWEEP_STEPS} steps), every other kernel 0")
        others = [v for k, v in counts.items() if k != kernel]
        if (kernel is not None and counts[kernel] != want) or any(others):
            raise AssertionError(f"sweep mode {mode} did not launch its kernel as expected")
        if kernel is not None:
            launches[kernel] = counts[kernel]
        if mel.shape != (B_TIME, T_TIME, sweep.cfg["audio_num_mel_bins"]) \
                or not torch.isfinite(mel).all():
            raise AssertionError(f"sweep mode {mode}: mel {tuple(mel.shape)}, finite "
                                 f"{bool(torch.isfinite(mel).all())}")
        mels[mode] = mel
    ref = mels["v1"]
    for mode in ("module", "v2", "v3", "hybrid"):
        err = (mels[mode] - ref).abs().max().item()
        scale = ref.abs().max().item()
        c = corr(mels[mode], ref)
        checked = mode != "module"
        log(f"[check] sweep mel, {mode} vs v1: max_abs_err={err:.6g} max_abs_ref={scale:.6g} "
            f"corr={c:.6f} " + (f"(tolerance: err <= {MEL_TOL_REL} * max_abs_ref, corr > "
                               f"{MEL_TOL_CORR})" if checked else "(record only)"))
        if checked and not (err <= MEL_TOL_REL * scale and c > MEL_TOL_CORR):
            raise AssertionError(f"the {mode} sweep's mel disagrees with v1's")
    del mels
    times = perf_sweep.sweep_sampler(perf_sweep.MODES, sweep=sweep, reps=reps)
    log(f"[timing lynx_variants] card={name_limit} B={B_TIME} T={T_TIME} steps={SWEEP_STEPS} "
        f"(mean of {reps}): " + " ".join(f"{m}_ms_per_step={t['ms_per_step']:.4f}"
                                          for m, t in times.items()))
    for mode in ("module", "v1", "v2", "v3"):
        busy = device_busy_ms(lambda: sweep.run(mode)) / SWEEP_STEPS
        log(f"[busy lynx_variants] {mode}: device busy {busy:.4f} ms per step of "
            f"{times[mode]['ms_per_step']:.4f} (share {busy / times[mode]['ms_per_step']:.3f})")
    del sweep
    torch.cuda.empty_cache()
    return launches


VOCODER_REPS = 3
VOCODER_ATOL = 2e-2      # each folded config vs (), the JAX bar of the fused-stage test
VOCODER_CORR = 0.999


def run_vocoder_sweep(name_limit: str, k2_stage_ms, k6_stage_ms) -> None:
    """Phase 10: the vocoder sweep at full size in every ``pallas_stages``
    config, then the stock layout; the launch counters are zeroed just before
    each checked call and read just after.  ``k2_stage_ms`` (stages 0, 1,
    phase 4) and ``k6_stage_ms`` (stages 0-4, phase 5d) are the kernels'
    times alone, which split the default config's call by stage."""
    import torch

    from xiaoicesing_io_tpu_torch.bench.check import (
        WAV_TOL_CORR, corr, launch_counts, zero_launch_counts,
    )
    from xiaoicesing_io_tpu_torch.tools import perf_sweep

    t0 = time.perf_counter()
    sweep = perf_sweep.VocoderSweep.random(device="cuda", B=B_TIME, T=T_TIME)
    h = sweep.generator.config
    stages = len(h.upsample_rates)
    units = len(h.resblock_kernel_sizes) * len(h.resblock_dilation_sizes[0])
    log(f"[setup vocoder_variants] shipped NSF-HiFiGAN {h.upsample_initial_channel} ch, "
        f"random weights, mel ~ N(0, 1) [{B_TIME}, {T_TIME}, {h.num_mels}], f0 "
        f"{perf_sweep.VOCODER_F0} Hz; built in {time.perf_counter() - t0:.1f}s")
    wavs = {}
    for config in perf_sweep.VOCODER_CONFIGS + (None,):
        name = "stock" if config is None else f"stages={config}"
        want = ({"fused_resblock_stage": 2, "resblock_unit": 0} if config is None else
                {"fused_resblock_stage": len(config),
                 "resblock_unit": units * (stages - len(config))})
        if config is not None:
            sweep.folded(config)  # fold the weights outside the counted call
        zero_launch_counts()
        wav = sweep.run(config)
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"[vocoder {name}] launches {counts}; expected {want}, every other kernel 0")
        if any(counts[k] != want.get(k, 0) for k in counts):
            raise AssertionError(f"vocoder {name} did not launch its kernels as expected")
        if wav.shape != (B_TIME, T_TIME * h.hop_size) or not torch.isfinite(wav).all():
            raise AssertionError(f"vocoder {name}: wav {tuple(wav.shape)}, finite "
                                 f"{bool(torch.isfinite(wav).all())}")
        wavs[config] = wav
    ref = wavs[()]
    for config in perf_sweep.VOCODER_CONFIGS[1:]:
        err = (wavs[config] - ref).abs().max().item()
        c = corr(wavs[config], ref)
        log(f"[check] vocoder wav, stages={config} vs (): max_abs_err={err:.6g} corr={c:.8f} "
            f"(tolerance: err <= {VOCODER_ATOL}, corr > {VOCODER_CORR})")
        if not (err <= VOCODER_ATOL and c > VOCODER_CORR):
            raise AssertionError(f"the vocoder's stages={config} wav disagrees with ()'s")
    err = (wavs[None] - wavs[(0, 1)]).abs().max().item()
    c = corr(wavs[None], wavs[(0, 1)])
    log(f"[check] vocoder wav, stock layout vs folded (0, 1): max_abs_err={err:.6g} corr={c:.8f} "
        f"(tolerance: corr > {WAV_TOL_CORR})")
    if not c > WAV_TOL_CORR:
        raise AssertionError("the stock layout's wav disagrees with the folded layout's")
    del wavs, ref
    times = perf_sweep.sweep_vocoder(sweep=sweep, reps=VOCODER_REPS)
    log(f"[timing vocoder_variants] card={name_limit} B={B_TIME} T={T_TIME} audio_s="
        f"{sweep.audio_s:.3f} (mean of {VOCODER_REPS}): "
        + " ".join(f"{k.replace('stages=', '').replace(' ', '')}_ms={v['ms']:.4f}"
                   for k, v in times.items()))
    ms = {k: v["ms"] for k, v in times.items()}
    # K2 on folded stage 2 has no timing of its own: K6's stage 2 plus the
    # (0, 1, 2) - (0, 1) difference of whole calls
    k2_stage2 = k6_stage_ms[2] + ms["stages=(0, 1, 2)"] - ms["stages=(0, 1)"]
    resblocks = k2_stage_ms[0] + k2_stage_ms[1] + sum(k6_stage_ms[2:])
    log(f"[split vocoder_variants] default config (0, 1), {ms['stages=(0, 1)']:.4f} ms a call: "
        f"resblocks of stage 0 (K2) {k2_stage_ms[0]:.4f}, stage 1 (K2) {k2_stage_ms[1]:.4f}, "
        + ", ".join(f"stage {i} (K6) {k6_stage_ms[i]:.4f}" for i in range(2, len(k6_stage_ms)))
        + f"; the rest (source, conv_pre, upsampling, noise convs, conv_post, adds) "
          f"{ms['stages=(0, 1)'] - resblocks:.4f}.  K6 against K2 per stage (kernel alone; "
          f"call differences in brackets): stage 0 {k6_stage_ms[0]:.4f} vs {k2_stage_ms[0]:.4f} "
          f"({ms['stages=(0,)'] - ms['stages=()']:+.4f}), stage 1 {k6_stage_ms[1]:.4f} vs "
          f"{k2_stage_ms[1]:.4f} ({ms['stages=(1,)'] - ms['stages=()']:+.4f}), stage 2 "
          f"{k6_stage_ms[2]:.4f} vs {k2_stage2:.4f} (from the calls)")
    del sweep
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the main path: .ds -> wav through the port's runner, for each configuration
# ---------------------------------------------------------------------------

SAMPLE = "samples/04_仙瑶.ds"
def drive_main_path(runner, out_dir: Path, params=None, what: str = SAMPLE) -> tuple:
    """Every segment of a ``.ds`` (default: the sample's) through
    ``run_inference``, recorded by the bench (``bench/cells.py:song_record``);
    returns the kernels' launch counts of that run, the ``.ds`` segments,
    the record and the wav it wrote."""
    import numpy as np
    from scipy.io import wavfile

    from xiaoicesing_io_tpu_torch.bench import cells
    from xiaoicesing_io_tpu_torch.bench.check import launch_counts, zero_launch_counts
    from xiaoicesing_io_tpu_torch.inference.acoustic import load_ds

    if params is None:
        params = load_ds(ROOT / SAMPLE)
    hooks, rec = cells.song_record(runner)
    zero_launch_counts()
    t0 = time.perf_counter()
    with hooks:
        (path,) = runner.run_inference(params, out_dir=out_dir, title="smoke", seed=0)
    seconds = time.perf_counter() - t0
    launches = launch_counts()

    hop, sr = runner.cfg["hop_size"], runner.cfg["audio_sample_rate"]
    segments = [(np.asarray(args[0]).shape[1], np.asarray(wav)) for args, _, wav in rec["vocoder"]]
    if len(segments) != len(params):
        raise AssertionError(f"{len(segments)} segments vocoded, {len(params)} in the .ds")
    for frames, wav in segments:
        if wav.shape != (frames * hop,) or not np.isfinite(wav).all():
            raise AssertionError(f"a segment of {frames} frames gave {wav.shape} samples, "
                                 f"finite {bool(np.isfinite(wav).all())}; expected "
                                 f"{frames * hop}, finite")
    expect = 0
    for param, (_, wav) in zip(params, segments):  # run_inference's placement of segments
        expect = round(param.get("offset", 0) * sr) + len(wav)
    rate, wav = wavfile.read(path)
    if rate != sr or wav.shape != (expect,) or not np.abs(wav).max() > 0:
        raise AssertionError(f"wav: {rate} Hz, shape {wav.shape}, peak {np.abs(wav).max()}; "
                             f"expected {sr} Hz, ({expect},), non-silent")
    log(f"[ds] {what}: {len(params)} segments, {sum(f for f, _ in segments)} frames -> "
        f"{wav.shape[0]} samples ({wav.shape[0] / sr:.2f} s) at {rate} Hz, finite, "
        f"each segment frames*{hop} samples; {seconds:.2f}s host; launches {launches}")
    return launches, params, rec, path


def check_against_f32(runner, params, rec) -> None:
    """Every segment of the recorded ``.ds`` run against the bench's plain
    f32 reference on the card, from the same inputs and seeds: mels and
    wavs must agree, and the song must be its segments placed
    (``bench/check.py:against_f32``)."""
    from xiaoicesing_io_tpu_torch.bench import cells, check, reference

    mels, wavs, ref_mels, ref_wavs = cells.song_outputs(runner, params, rec)(
        reference.Reference(runner.cfg, runner.device))
    out = check.against_f32(mels, ref_mels, wavs, ref_wavs)
    log(f"[check] the .ds run against the f32 reference, worst of {out['sequences']} segments: "
        f"mel max_abs_err={out['mel_max_abs_err']:.6g} max_abs_ref={out['mel_max_abs_ref']:.6g} "
        f"(rel {out['mel_rel_err']:.6g}) corr={out['mel_corr']:.8f}; wav corr="
        f"{out['wav_corr']:.8f} (tolerance: {check.tolerance_text()})")


# ---------------------------------------------------------------------------
# batched timing, through the bench's batch cell
# ---------------------------------------------------------------------------

TIMING_RUNS = 2  # the bench's batch cells run 7; each run is 20 back-to-back calls


def batched_timing(runner, cell: str, name_limit: str, label: str, kernels: dict) -> dict:
    """The bench's batch cell ``cell`` (``bench/cells.py``: B=4 sequences of
    T=2048 frames, runs of 20 synthesis + vocoder calls) at
    :data:`TIMING_RUNS` runs, on ``runner``; the line also carries the
    kernels' phase 3-5 times against their bounds."""
    from xiaoicesing_io_tpu_torch.bench import cells

    res = cells.measure_cell(cell, runner, runs=TIMING_RUNS)
    m = res["metrics"]
    out = {"audio_s_per_s": m["audio_s_per_s"]["median"],
           "latency_ms": m["latency_s"]["median"] * 1e3, "mfu": m["mfu"]["median"],
           "cond_aux_ms": m["cond_aux_ms"], "sampler_ms_per_step": m["sampler_ms_per_step"],
           "vocoder_ms": m["vocoder_ms"], "device_busy_share": m["device_busy_share"]}
    log(f"[timing {label}] card={name_limit} cell={cell} {res['shape']} steps={res['steps']} "
        f"(median of {TIMING_RUNS} runs; stages from a run synchronised between them): "
        + " ".join(f"{k}={v:.4f}" if v is not None else f"{k}=not measured"
                   for k, v in out.items())
        + f" failed/attempted={res['failed']}/{res['attempted']} "
        + " ".join(f"{k}_ms={v['ms']:.4f} {k}_bound_ms={v['bound_ms']:.4f}"
                   for k, v in kernels.items()))
    if not res["correct"]:
        raise AssertionError(f"{cell}: {res['failed']} of {res['attempted']} calls gave a "
                             f"non-finite or misshapen wav")
    return out


def run_configuration(label: str, cell: str, work: Path, name_limit: str,
                      kernels: dict) -> tuple:
    """Phases 6 and 7: a random full-width experiment of the bench's cell
    ``cell``, the ``.ds`` run, its check against the f32 reference and the batched
    timing; returns the ``.ds`` run's launch counts, the runner (phase 15
    serves on it), the wav and the vocoder's launches per call.  Every kernel must launch as
    ``bench/check.py:implied_launches`` says per segment: the denoiser's (K1
    for LYNXNet, K4 for WaveNet) once per layer per sampler step, K2 and K6
    as the vocoder's layout says, every other kernel never."""
    import torch

    from xiaoicesing_io_tpu_torch.bench import cells, check

    runner, seconds = cells.open_cell(cell, work, device="cuda")
    log(f"[setup {label}] random full-width acoustic model and vocoder saved and loaded in "
        f"{seconds:.1f}s; runner on {runner.device}, kernels on")
    launches, params, rec, wav = drive_main_path(runner, work / "out")
    segments = len(params)
    implied = check.implied_launches(runner, segments, segments)
    per_call = check.vocoder_calls(runner.vocoder)
    log(f"[ds {label}] launches {launches}; expected { {k: v for k, v in implied.items() if v} } "
        f"(layers x {check.sampler_steps(runner)} steps x {segments} segments; per segment's "
        f"vocoder call {per_call}), every other kernel 0")
    check.check_launches(launches, implied, True, f"the {label} .ds run")
    check_against_f32(runner, params, rec)
    batched_timing(runner, cell, name_limit, label, kernels)
    torch.cuda.empty_cache()
    return launches, runner, wav, per_call


# ---------------------------------------------------------------------------
# the variance -> acoustic pipeline: score -> infer variance -> infer acoustic (K4; K1, K2, K6)
# ---------------------------------------------------------------------------

CURVES = ("energy", "breathiness", "voicing", "tension")
SPEAKERS = {"s0": 0, "s1": 1}
SPK_MIX = "s0:0.4|s1:0.6"          # the static mix of --spk on infer variance
PITCH_TOL_CENTS = 10.0             # RMS, K4's bf16 pitch against the f32 module's
PITCH_MIN_CORR = 0.999
CURVE_TOL_SHARE = 0.01             # RMS over the curve normalizer's range


def make_variance_experiment(work: Path, diffusion_type: str, seed: int = 0):
    """A reference-format variance checkpoint at the shipped widths
    (``configs/variance.json``: fs2 256 x 4, durations 512 x 5, pitch WaveNet
    256 x 20 at cycle 5, variance WaveNet 192 x 10 at cycle 4) with every
    curve predicted and two speakers, random weights from ``seed``; the
    WaveNets' zero-initialised output projections are drawn too, and the
    duration head's bias is 1.5, so that no phoneme's duration is clamped to
    0.  Returns the config the runner loads."""
    import torch

    from xiaoicesing_io_tpu_torch.config import variance_defaults
    from xiaoicesing_io_tpu_torch.models.toplevel import VarianceModel
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    cfg = variance_defaults()
    cfg.update(work_dir=str(work), dictionary=str(ROOT / cfg["dictionary"]), use_spk_id=True,
               num_spk=len(SPEAKERS), diffusion_type=diffusion_type,
               **{f"predict_{v}": True for v in CURVES})
    vocab = TokenTextEncoder(PhonemeDictionary.load(cfg["dictionary"]).phoneme_list).vocab_size
    torch.manual_seed(seed)
    model = VarianceModel.from_config(cfg, vocab)
    with torch.no_grad():
        for backbone in (model.pitch_backbone, model.variance_backbone):
            backbone.output_projection.weight.normal_(0.0, 0.02)
        model.fs2.dur_predictor.linear.bias.fill_(1.5)
    work.mkdir(parents=True)
    torch.save({"category": "variance",
                "state_dict": {f"model.{k}": v for k, v in model.state_dict().items()}},
               work / "model_ckpt_steps_0.ckpt")
    (work / "spk_map.json").write_text(json.dumps(SPEAKERS))
    return cfg


def check_written_ds(runner, bare, written) -> int:
    """Each written segment: ``ph_dur`` in whole frames whose sum over each
    word is the word's duration (to the rounding of its phonemes, half a
    frame each), and finite ``f0_seq`` and curves of one value a frame.
    Returns the number of words whose sum is exact."""
    import numpy as np

    exact = words = 0
    for i, (seg, out) in enumerate(zip(bare, written)):
        batch = runner.preprocess_input(seg, idx=i)
        ph2word, word_dur = batch["ph2word"][0], batch["word_dur"][0]
        frames = batch["mel2note"].shape[1]
        dur = np.array(out["ph_dur"].split(), np.float64) / runner.timestep
        if len(dur) != len(ph2word) or np.abs(dur - np.round(dur)).max() > 1e-3:
            raise AssertionError(f"segment {i}: ph_dur is not {len(ph2word)} whole frames")
        sums = np.zeros(len(word_dur) + 1)
        np.add.at(sums, ph2word, np.round(dur))
        phones = np.bincount(ph2word, minlength=len(word_dur) + 1)
        if (np.abs(sums[1:] - word_dur) > 0.5 * phones[1:]).any() or sums[1:].min() <= 0:
            raise AssertionError(f"segment {i}: word sums {sums[1:]} against {word_dur}")
        exact += int((sums[1:] == word_dur).sum())
        words += len(word_dur)
        for key in ("f0_seq", *CURVES):
            values = np.array(out[key].split(), np.float64)
            if values.shape != (frames,) or not np.isfinite(values).all():
                raise AssertionError(f"segment {i}: {key} has {values.shape} values, finite "
                                     f"{bool(np.isfinite(values).all())}; expected {frames}")
        if not (np.array(out["f0_seq"].split(), np.float64) > 0).all():
            raise AssertionError(f"segment {i}: f0 not positive")
    log(f"[variance ds] {len(written)} segments written: ph_dur whole frames, word sums within "
        f"the rounding of their phonemes ({exact} of {words} words exact), f0 and "
        f"{'/'.join(CURVES)} finite, one value a frame")
    return exact


def check_variance_against_f32(runner, seg) -> None:
    """One segment through the kernel path and the f32 modules on the card,
    from the same seed (the same noise): durations equal (no K4 in the
    duration head), pitch within :data:`PITCH_TOL_CENTS` RMS at corr >
    :data:`PITCH_MIN_CORR`, each curve within :data:`CURVE_TOL_SHARE` of its
    normalizer's range RMS."""
    import numpy as np

    flags = runner.segment_flags(seg)
    batch = runner.preprocess_input(seg, load_dur=not flags[0] and (flags[1] or flags[2]),
                                    load_pitch=not flags[1] and flags[2])
    kd, kp, kv = runner.forward_model(batch, flags, seed=0)
    fd, fp, fv = runner.forward_model(batch, flags, seed=0, _f32_module=True)
    if not np.array_equal(kd, fd):
        raise AssertionError("the duration head differs between the two paths")
    cents = 100.0 * (kp - fp)
    rms = float(np.sqrt(np.mean(cents ** 2)))
    corr = float(np.corrcoef(kp.ravel(), fp.ravel())[0, 1])
    line = (f"pitch max_abs_err={np.abs(cents).max():.4f} cents rms={rms:.4f} cents "
            f"corr={corr:.8f} (tolerance rms <= {PITCH_TOL_CENTS}, corr > {PITCH_MIN_CORR})")
    ok = rms <= PITCH_TOL_CENTS and corr > PITCH_MIN_CORR
    norm = runner.normalizers["variances"]
    spans = (norm.spec_max - norm.spec_min).reshape(norm.num_feats, -1)[:, 0]
    for name, span in zip(runner.model.variance_prediction_list, spans.tolist()):
        err = kv[name] - fv[name]
        share = float(np.sqrt(np.mean(err ** 2))) / span
        line += f"; {name} max_abs_err={np.abs(err).max():.4f} rms/range={share:.6f}"
        ok = ok and share <= CURVE_TOL_SHARE
    log(f"[check variance] K4 (bf16) against the f32 modules, one segment of "
        f"{kp.shape[1]} frames: {line} (curves: rms/range <= {CURVE_TOL_SHARE})")
    if not ok:
        raise AssertionError("the variance heads on K4 disagree with their f32 modules")


def variance_inputs(segs, timestep: float) -> list:
    """The written ``.ds`` with the acoustic runner's optional inputs as
    curves at the frame rate: a two-speaker dynamic mix, a ``gender`` curve
    and a ``velocity`` curve."""
    import numpy as np

    out = []
    for seg in segs:
        n = len(seg["f0_seq"].split())
        t = np.arange(n) * timestep
        mix = 0.5 + 0.5 * np.sin(2 * np.pi * t / 3.0)

        def text(x):
            return " ".join(f"{v:.4f}" for v in x)
        out.append(dict(seg, spk_mix={"s0": text(mix), "s1": text(1.0 - mix)},
                        spk_mix_timestep=str(timestep),
                        gender=text(0.6 * np.sin(2 * np.pi * t / 5.0)),
                        gender_timestep=str(timestep),
                        velocity=text(1.0 + 0.4 * np.sin(2 * np.pi * t / 4.0)),
                        velocity_timestep=str(timestep)))
    return out


def run_variance_pipeline(work: Path, name_limit: str) -> tuple:
    """Phase 7b: ``infer variance`` on the bare score of the sample song
    (durations, pitch and curves removed; a static two-speaker mix) at full
    width on the card, then the written ``.ds`` through ``infer acoustic``
    with every optional input (variance curves, a dynamic speaker mix,
    gender, velocity).  Returns the variance song's launch counts and the
    variance experiment's config."""
    import torch

    from xiaoicesing_io_tpu_torch.bench import cells, check
    from xiaoicesing_io_tpu_torch.bench.experiment import make_experiment
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer, load_ds
    from xiaoicesing_io_tpu_torch.inference.variance import DiffSingerVarianceInfer
    from xiaoicesing_io_tpu_torch.utils.spk_mix import parse_commandline_spk_mix

    t_phase = t0 = time.perf_counter()
    variance_cfg = make_variance_experiment(work / "variance", "reflow")
    runner = DiffSingerVarianceInfer(variance_cfg, device="cuda")
    log(f"[setup variance] random full-width variance model saved and loaded in "
        f"{time.perf_counter() - t0:.1f}s; heads on K4: {sorted(runner.kernel_weights)}")
    drop = {"ph_dur", "f0_seq", "f0_timestep", *CURVES, *(f"{v}_timestep" for v in CURVES)}
    mix = parse_commandline_spk_mix(SPK_MIX)
    bare = [dict({k: v for k, v in p.items() if k not in drop}, ph_spk_mix=mix, spk_mix=mix)
            for p in load_ds(ROOT / SAMPLE)]
    n = len(bare)
    layers = {h: len(b.residual_layers) for h, b in runner.heads().items()}
    steps = check.sampler_steps(runner)
    expect = {name: 0 for name, _, _ in check.counters()}
    expect["wavenet_block"] = n * steps * sum(layers.values())
    out_dir = work / "variance_out"
    check.zero_launch_counts()
    t0 = time.perf_counter()
    (path,) = runner.run_inference(bare, out_dir, "variance", seed=0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = check.launch_counts()
    log(f"[variance] {SAMPLE} bare score, {n} segments, --spk {SPK_MIX}: {seconds:.2f}s; "
        f"launches {launches}; expected wavenet_block {n} segments x {steps} steps x "
        f"({' + '.join(f'{h} {k}' for h, k in layers.items())} layers), every other kernel 0")
    check.check_launches(launches, expect, True, "the variance song")
    written = load_ds(path)
    check_written_ds(runner, bare, written)
    check_variance_against_f32(runner, bare[0])
    frames = sum(len(seg["f0_seq"].split()) for seg in written)
    audio_s = frames * runner.timestep

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.run_inference(bare, work / "variance_prof", "variance", seed=0)
        torch.cuda.synchronize()
    k4_ms = sum(e.self_device_time_total for e in prof.key_averages()
                if e.self_cpu_time_total == 0 and ("GateEpi" in e.key
                                                   or "StoreBiasBf16" in e.key)) / 1e3
    log(f"[timing variance] card={name_limit} song={SAMPLE} segments={n} frames={frames} "
        f"steps={steps} variance_s={seconds:.4f} k4_device_ms="
        + (f"{k4_ms:.4f}" if k4_ms > 0 else "not measured (no device time in the trace)")
        + f" audio_s={audio_s:.4f} audio_s_per_s={audio_s / seconds:.4f}")
    del runner
    torch.cuda.empty_cache()

    ddpm = DiffSingerVarianceInfer(make_variance_experiment(work / "variance_ddpm", "ddpm"),
                                   device="cuda")
    steps = check.sampler_steps(ddpm)
    want = dict(expect, wavenet_block=steps * sum(layers.values()))
    check.zero_launch_counts()
    (path,) = ddpm.run_inference(bare[:1], work / "ddpm_out", "variance", seed=0)
    got = check.launch_counts()
    log(f"[variance ddpm] one segment, DDIM {steps} steps of 1000 at speedup "
        f"{ddpm.cfg['diff_speedup']}: launches {got}; expected wavenet_block "
        f"{want['wavenet_block']}")
    check.check_launches(got, want, True, "the DDPM variance segment")
    check_written_ds(ddpm, bare[:1], load_ds(path))
    del ddpm
    torch.cuda.empty_cache()

    over = cells.cell_overrides(cells.CELLS["lynx_reflow_b4_t2048"])
    over.update(use_spk_id=True, num_spk=len(SPEAKERS), use_key_shift_embed=True,
                use_speed_embed=True, **{f"use_{v}_embed": True for v in CURVES})
    cfg = make_experiment(work / "acoustic", over)
    (Path(cfg["work_dir"]) / "spk_map.json").write_text(json.dumps(SPEAKERS))
    acoustic = DiffSingerAcousticInfer(cfg, device="cuda")
    segs = variance_inputs(written, acoustic.timestep)
    launches_a, segs, rec, _ = drive_main_path(acoustic, work / "acoustic_out", segs,
                                               "the written .ds")
    implied = check.implied_launches(acoustic, n, n)
    log(f"[ds variance -> acoustic] launches {launches_a}; expected "
        f"{ {k: v for k, v in implied.items() if v} } (as phase 6), every other kernel 0")
    check.check_launches(launches_a, implied, True, "the acoustic run of the written .ds")
    worst = None
    for args, kwargs, mel in rec["segment"]:
        ref = acoustic.forward_model(args[0], seed=kwargs["seed"], _f32_module=True)
        got = check.compare_mel(mel, ref)
        check.require(got["mel_ok"], f"a segment's mel disagrees with the f32 path: {got}")
        if worst is None or got["mel_rel_err"] > worst["mel_rel_err"]:
            worst = got
    log(f"[check variance -> acoustic] every segment's mel (speakers, curves, gender, velocity "
        f"on) against the runner's f32 module path from the same noise, worst: mel "
        f"max_abs_err={worst['mel_max_abs_err']:.6g} max_abs_ref={worst['mel_max_abs_ref']:.6g} "
        f"(rel {worst['mel_rel_err']:.6g}) corr={worst['mel_corr']:.8f} (tolerance: "
        f"{check.tolerance_text()})")
    del acoustic
    torch.cuda.empty_cache()
    log(f"[done 7b] {time.perf_counter() - t_phase:.1f}s")
    return launches, variance_cfg


# ---------------------------------------------------------------------------
# copy-synthesis: wav -> mel -> f0 -> NSF-HiFiGAN -> wav, scored (K3, K2)
# ---------------------------------------------------------------------------

SYNTH_FILE_SR = 22050
SYNTH_F0 = 220.0
F0_TOL_CENTS = 50.0
F0_MIN_AGREEMENT = 0.9
MAE_TOL = 1e-4


def synthetic_clip(path: Path, hop: int, sr: int, frames: int = K3_FRAMES, seed: int = 0):
    """A harmonic tone with +-50 cent vibrato at 5.5 Hz around 220 Hz and
    white noise 40 dB below it, ``frames * hop`` samples at ``sr`` once
    resampled, written at 22.05 kHz; returns its f0 at the frame centres."""
    import numpy as np

    from xiaoicesing_io_tpu_torch.utils.audio import save_wav

    def f0_at(t):
        return SYNTH_F0 * 2.0 ** (0.5 * np.sin(2 * np.pi * 5.5 * t) / 12)

    n = frames * hop * SYNTH_FILE_SR // sr
    t = np.arange(n) / SYNTH_FILE_SR
    phase = 2 * np.pi * np.cumsum(f0_at(t)) / SYNTH_FILE_SR
    x = sum(np.sin(k * phase) / k for k in range(1, 9))
    x = 0.5 * x / np.abs(x).max()
    rms = np.sqrt(np.mean(x ** 2))
    x = x + np.random.default_rng(seed).standard_normal(n) * rms * 10 ** (-40 / 20)
    save_wav(x, path, SYNTH_FILE_SR)
    return f0_at(np.arange(frames) * hop / sr)


def run_copy_synthesis(cfg, ds_wav: Path, work: Path, name_limit: str, per_call: dict) -> dict:
    """Phase 8: ``copy_synthesis`` on the card (the launch counters are zeroed
    just before it and read just after); ``per_call`` is the vocoder's K2 and
    K6 launches per call.  Returns its launch counts."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from xiaoicesing_io_tpu_torch.bench.check import launch_counts, zero_launch_counts
    from xiaoicesing_io_tpu_torch.eval.metrics import f0_rmse_cents
    from xiaoicesing_io_tpu_torch.inference import val_vocoder as V

    hop, sr = cfg["hop_size"], cfg["audio_sample_rate"]
    work.mkdir(parents=True)
    synth = work / "synthetic_tone.wav"
    known_f0 = synthetic_clip(synth, hop, sr)
    pairs, pitches = [], []
    score, pitch = V._score_pair, V.get_pitch

    def score_pair(extractor, wav, rec, mel, device, plain=False):
        pairs.append((extractor, wav, rec, mel, device))
        return score(extractor, wav, rec, mel, device, plain)

    def get_pitch(*args, **kwargs):
        out = pitch(*args, **kwargs)
        pitches.append(out)
        return out

    V._score_pair, V.get_pitch = score_pair, get_pitch
    try:
        zero_launch_counts()
        t0 = time.perf_counter()
        results = V.copy_synthesis([ds_wav, synth], cfg, work / "out", device="cuda")
        seconds = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        V._score_pair, V.get_pitch = score, pitch

    want = {"mel_spectrogram": 2, **{k: 2 * v for k, v in per_call.items()}}
    log(f"[copysyn] launches {launches}; expected {want} (two files: one K3 call and one "
        f"vocoder call each)")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError("copy-synthesis did not launch its kernels as expected")
    audio_s = 0.0
    for res, (extractor, wav, rec, mel, device), (f0, uv) in zip(results, pairs, pitches):
        rate, out = wavfile.read(res["out"])
        if (device is None or device.type != "cuda" or not np.isfinite(rec).all()
                or len(rec) != len(mel) * hop or rate != sr or out.shape != rec.shape):
            raise AssertionError(f"{res['file']}: reconstruction of {len(rec)} samples "
                                 f"({len(mel)} frames, scored on {device}) written as "
                                 f"{out.shape} at {rate} Hz")
        plain = score(extractor, wav, rec, mel, device, plain=True)
        host = score(extractor, wav, rec, mel, None)
        audio_s += len(wav) / sr
        st = res["seconds"]
        log(f"[copysyn] {Path(res['file']).name}: {len(mel)} frames ({len(wav) / sr:.3f} s), "
            f"mel_mae K3={res['mel_mae']:.6f} plain={plain:.6f} |diff|="
            f"{abs(res['mel_mae'] - plain):.3g} (tolerance {MAE_TOL}); host-path mel_mae="
            f"{host:.6f} (record only: its tail frames are not bucket-padded); "
            f"pesq*={res['pesq']:.4f}")
        log(f"[copysyn stages] {Path(res['file']).name}: "
            + " ".join(f"{k}_s={v:.4f}" for k, v in st.items())
            + f" (load, GT mel, pitch, save, PESQ* on the host; vocoder and K3 pair on the "
              f"card) total_s={sum(st.values()):.4f}")
        if not abs(res["mel_mae"] - plain) <= MAE_TOL:
            raise AssertionError("the K3-scored mel MAE disagrees with the plain version's")
    f0, uv = pitches[1]
    rmse, agreement = f0_rmse_cents(np.where(uv, 0.0, f0), known_f0)
    log(f"[copysyn] synthetic clip f0 vs its known curve: rmse={rmse:.4f} cents "
        f"(tolerance < {F0_TOL_CENTS}), voicing agreement={agreement:.4f} "
        f"(tolerance > {F0_MIN_AGREEMENT})")
    if not (rmse < F0_TOL_CENTS and agreement > F0_MIN_AGREEMENT):
        raise AssertionError("the pitch tracker missed the synthetic clip's f0")
    log(f"[timing copysyn] card={name_limit} files=2 audio_s={audio_s:.3f} "
        f"seconds={seconds:.4f} audio_s_per_s={audio_s / seconds:.4f}")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# evaluation over binarized sets: evaluate_acoustic (K1; K2, K6), evaluate_variance (K4)
# ---------------------------------------------------------------------------

PITCH_ACC_MIN = 0.999   # K4's bf16 pitch against the f32 modules' at 0.5 semitones
PESQ_SAME = 1e-6        # one item with and without pad_frames_to: the host's rounding only


def write_set(directory: Path, prefix: str, items: list) -> None:
    """A binarized set as the binarizers write it: the items through the
    port's ``IndexedDatasetBuilder`` and the ``.meta`` pickle (frame counts,
    each array's length, names)."""
    import pickle

    from xiaoicesing_io_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder

    directory.mkdir(parents=True, exist_ok=True)
    builder = IndexedDatasetBuilder(directory, prefix)
    for item in items:
        builder.add_item(item)
    builder.finalize()
    with open(directory / f"{prefix}.meta", "wb") as f:
        pickle.dump({"lengths": [len(it["mel2ph"]) for it in items],
                     **{k: [len(it[k]) for it in items] for k in items[0]
                        if getattr(items[0][k], "ndim", 0)},
                     "names": [f"segment{i}" for i in range(len(items))]}, f)


def acoustic_eval_set(cfg, work: Path, seed: int) -> list:
    """The sample ``.ds``'s segments as a ``valid`` set (tokens, ``mel2ph``
    and f0 from the runner's ``preprocess_input``) whose ground-truth mel is
    the runner's f32 module path on the collated item from the seed the
    evaluation gives it (``seed + i``).  Returns the items and those mels at
    the collated length."""
    import numpy as np

    from xiaoicesing_io_tpu_torch.data.dataset import AcousticDataset
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import _batch_from_item
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer, load_ds

    runner = DiffSingerAcousticInfer(cfg, load_vocoder=False, device="cuda")
    items = []
    for i, seg in enumerate(load_ds(ROOT / SAMPLE)):
        b = runner.preprocess_input(seg, idx=i)
        items.append({"tokens": b["tokens"][0], "mel2ph": b["mel2ph"][0], "f0": b["f0"][0],
                      "mel": np.zeros((b["mel2ph"].shape[1], cfg["audio_num_mel_bins"]),
                                      np.float32)})
    write_set(work / "draft", "valid", items)
    draft = AcousticDataset(work / "draft", "valid", cfg)
    mels = []
    for i, item in enumerate(items):
        batch = _batch_from_item(cfg, runner, draft.collate([i]))
        mel = runner.forward_model(batch, seed=seed + i, _f32_module=True)[0]
        item["mel"] = mel[:len(item["mel2ph"])]
        mels.append(mel)
    draft._ds.close()
    write_set(Path(cfg["binary_data_dir"]), "valid", items)
    del runner
    return items, mels


def variance_eval_set(cfg, work: Path) -> list:
    """The sample ``.ds``'s segments as a variance ``valid`` set (the
    runner's ``preprocess_input`` with durations and pitch; ``uv`` from the
    ``.ds``'s f0) whose ``pitch`` is the f32 modules' sample under the
    evaluation's condition from the noise the evaluation draws (item ``i``'s
    generator).  Returns the items."""
    import numpy as np

    from xiaoicesing_io_tpu_torch.data.dataset import VarianceDataset
    from xiaoicesing_io_tpu_torch.inference.acoustic import load_ds
    from xiaoicesing_io_tpu_torch.inference.variance import DiffSingerVarianceInfer
    from xiaoicesing_io_tpu_torch.training.variance import sample_variance_inference
    from xiaoicesing_io_tpu_torch.utils import generator_from_seed
    from xiaoicesing_io_tpu_torch.utils.curves import interp_f0, resample_align_curve

    runner = DiffSingerVarianceInfer(cfg, device="cuda")
    items = []
    for i, seg in enumerate(load_ds(ROOT / SAMPLE)):
        b = runner.preprocess_input(seg, idx=i, load_dur=True, load_pitch=True)
        T = b["mel2ph"].shape[1]
        f0 = resample_align_curve(np.array(seg["f0_seq"].split(), np.float32),
                                  float(seg["f0_timestep"]), runner.timestep, T)
        item = {k: b[k][0] for k in ("tokens", "ph_dur", "midi", "ph2word", "mel2ph",
                                     "note_midi", "note_rest", "note_dur", "note_glide",
                                     "mel2note", "base_pitch", "pitch")}
        item.update(uv=interp_f0(f0)[1], spk_id=0,
                    **{v: np.zeros(T, np.float32) for v in runner.model.variance_prediction_list})
        items.append(item)
    write_set(work / "draft_variance", "valid", items)
    draft = VarianceDataset(work / "draft_variance", "valid", cfg)
    for i, item in enumerate(items):
        pitch, _ = sample_variance_inference(
            cfg, runner.model, runner.core, runner.normalizers, draft.collate([i]),
            generator=generator_from_seed(i, runner.device))
        item["pitch"] = pitch[0, :len(item["mel2ph"])].cpu().numpy()
    draft._ds.close()
    write_set(Path(cfg["binary_data_dir"]), "valid", items)
    del runner
    return items


def check_ddsp(work: Path) -> None:
    """The DDSP wrapper on the card: a TorchScript stand-in for a pc-ddsp
    archive (mel ``[B, T, M]`` and f0 -> signal) with its ``config.yaml``,
    loaded onto the card, against the same archive on the CPU."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.models.vocoders import get_vocoder_cls

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(128, 512)

        def forward(self, mel, f0):
            frames = torch.tanh(self.proj(mel)) * torch.sin(f0 / 50.0)
            return frames.reshape(mel.shape[0], -1), frames, (frames, frames)

    work.mkdir(parents=True)
    torch.manual_seed(0)
    mel = torch.zeros(1, 4, 128)
    torch.jit.trace(Toy(), (mel, torch.ones(1, 4, 1))).save(str(work / "model.pt"))
    (work / "config.yaml").write_text(
        "data:\n  sampling_rate: 44100\n  n_mels: 128\n  block_size: 512\n")
    cfg = {"vocoder_ckpt": str(work / "model.pt"), "mel_base": "e", "hop_size": 512,
           "audio_sample_rate": 44100, "audio_num_mel_bins": 128}
    ddsp = get_vocoder_cls("DDSP")
    rng = np.random.default_rng(0)
    mel = (rng.standard_normal((200, 128)) - 4.0).astype(np.float32)
    f0 = rng.uniform(100, 400, 200).astype(np.float32)
    got = ddsp(cfg, device="cuda").spec2wav(mel, f0)
    ref = ddsp(cfg, device="cpu").spec2wav(mel, f0)
    err = float(np.abs(got - ref).max())
    log(f"[eval ddsp] DDSP (TorchScript) on the card: {got.shape[0]} samples, max_abs_err "
        f"{err:.3g} against the CPU (tolerance 1e-4)")
    if got.shape != (200 * 512,) or not err <= 1e-4:
        raise AssertionError("the DDSP wrapper on the card disagrees with the CPU")


def run_evaluation(lynx_cfg, variance_cfg, work: Path, name_limit: str, per_call: dict) -> dict:
    """Phase 12: ``evaluate_acoustic`` (with PESQ*) on the LYNXNet
    experiment of phase 6 and ``evaluate_variance`` on the variance
    experiment of phase 7b, over sets built from the sample ``.ds`` whose
    ground truths are the f32 module paths' outputs from the evaluation's
    own noise; the launch counters are zeroed just before each evaluation
    and read just after.  Returns the launches of both."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.config import Config
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import evaluate_acoustic, evaluate_variance
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer
    from xiaoicesing_io_tpu_torch.training import variance as training_variance

    t_phase = time.perf_counter()
    seed = 0
    cfg = Config(lynx_cfg, binary_data_dir=str(work / "binary"))
    items, f32_mels = acoustic_eval_set(cfg, work, seed)
    n = len(f32_mels)
    mels = []
    forward = DiffSingerAcousticInfer.forward_model

    def recorded(self, batch, seed=0, noise=None, _f32_module=False):
        out = forward(self, batch, seed=seed, noise=noise, _f32_module=_f32_module)
        mels.append(out[0])
        return out

    DiffSingerAcousticInfer.forward_model = recorded
    try:
        check.zero_launch_counts()
        t0 = time.perf_counter()
        report = evaluate_acoustic(cfg, "valid", seed=seed, with_pesq=True, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = check.launch_counts()
    finally:
        DiffSingerAcousticInfer.forward_model = forward
    layers, steps = cfg["backbone_args"]["num_layers"], cfg["sampling_steps"]
    expect = {name: 0 for name, _, _ in check.counters()}
    expect["lynx_conv_module"] = layers * steps * n
    for name, k in per_call.items():
        expect[name] = 3 * k * n
    log(f"[eval acoustic] {n} items: {seconds:.2f}s ({n / seconds:.4f} items/s); launches "
        f"{launches}; expected lynx_conv_module {layers} layers x {steps} steps x {n}, per item "
        f"3 vocoder calls (prediction, ground truth, aux) of {per_call}, every other kernel 0")
    check.check_launches(launches, expect, True, "evaluate_acoustic")
    worst = None
    for mel, ref in zip(mels, f32_mels, strict=True):
        got = check.compare_mel(mel, ref)
        check.require(got["mel_ok"], f"an item's mel disagrees with its f32 ground truth: {got}")
        if worst is None or got["mel_rel_err"] > worst["mel_rel_err"]:
            worst = got
    numbers = [v for it in report["items"] for k, v in it.items()
               if isinstance(v, float) or k in ("pesq", "aux_pesq")]
    numbers += [v for k, v in report.items() if k.startswith("mean_")]
    check.require(all(v is not None and np.isfinite(v) for v in numbers),
                  f"evaluate_acoustic reported a number that is not finite: {report}")
    log(f"[eval acoustic] each item's mel (K1, bf16) against its f32 ground truth, worst: "
        f"max_abs_err={worst['mel_max_abs_err']:.6g} max_abs_ref={worst['mel_max_abs_ref']:.6g}"
        f" (rel {worst['mel_rel_err']:.6g}) corr={worst['mel_corr']:.8f} (tolerance: "
        f"{check.tolerance_text()}); the NSF-HiFiGAN vocoder ran (no Griffin-Lim); "
        + " ".join(f"{k}={v:.6f}" for k, v in report.items() if k.startswith("mean_"))
        + f" diff_pesq_wins_items={report['diff_pesq_wins_items']}")

    # item i again, alone (as the train set, with its seed), with pad_frames_to: the
    # collated length grows to the runner's bucket, which stays
    frames = [len(it["mel2ph"]) for it in items]
    i = next(j for j, t in enumerate(frames) if -(-t // 128) % 2 == 1)
    bucket = -(-frames[i] // 256) * 256
    write_set(work / "binary", "train", [items[i]])
    padded = evaluate_acoustic(cfg, "train", seed=seed + i, with_pesq=True,
                               pad_frames_to=bucket, device="cuda")["items"][0]
    plain = report["items"][i]
    log(f"[eval acoustic] item {i} ({frames[i]} frames, collated {-(-frames[i] // 128) * 128}) "
        f"again with pad_frames_to={bucket}: pesq {padded['pesq']:.9f} against "
        f"{plain['pesq']:.9f}, wav_mcd_db {padded['wav_mcd_db']:.6f} against "
        f"{plain['wav_mcd_db']:.6f} (tolerance {PESQ_SAME})")
    check.require(abs(padded["pesq"] - plain["pesq"]) <= PESQ_SAME
                  and abs(padded["aux_pesq"] - plain["aux_pesq"]) <= PESQ_SAME,
                  "pad_frames_to changed the waveform scores")
    torch.cuda.empty_cache()

    vcfg = Config(variance_cfg, binary_data_dir=str(work / "variance_binary"))
    vitems = variance_eval_set(vcfg, work)
    layers = vcfg["pitch_prediction_args"]["backbone_args"]["num_layers"]
    steps = vcfg["sampling_steps"]
    pitches = []
    sample = training_variance.sample_variance_inference

    def recorded_pitch(*args, **kwargs):
        out = sample(*args, **kwargs)
        pitches.append(out[0][0].float().cpu().numpy())
        return out

    training_variance.sample_variance_inference = recorded_pitch
    try:
        check.zero_launch_counts()
        t0 = time.perf_counter()
        vreport = evaluate_variance(vcfg, "valid", device="cuda")
        torch.cuda.synchronize()
        vseconds = time.perf_counter() - t0
        vlaunches = check.launch_counts()
    finally:
        training_variance.sample_variance_inference = sample
    vexpect = {name: 0 for name, _, _ in check.counters()}
    vexpect["wavenet_block"] = layers * steps * n
    log(f"[eval variance] {n} items: {vseconds:.2f}s ({n / vseconds:.4f} items/s); launches "
        f"{vlaunches}; expected wavenet_block {layers} layers x {steps} steps x {n} (the pitch "
        f"head), every other kernel 0")
    check.check_launches(vlaunches, vexpect, True, "evaluate_variance")
    log(f"[eval variance] pitch_acc={vreport['pitch_acc']:.6f} (K4, bf16, against the f32 "
        f"modules from the same noise at 0.5 semitones; tolerance >= {PITCH_ACC_MIN}) "
        f"rhythm_corr={vreport['rhythm_corr']:.6f} ph_dur_acc={vreport['ph_dur_acc']:.6f} "
        f"median_wordsum_rel_err={vreport['median_wordsum_rel_err']:.6f} "
        f"n_words={vreport['n_words']}")
    check.require(vreport["pitch_acc"] >= PITCH_ACC_MIN,
                  "the pitch head on K4 disagrees with its f32 modules")
    cents = 100.0 * np.concatenate([p[:len(it["pitch"])] - it["pitch"]
                                    for p, it in zip(pitches, vitems, strict=True)])
    rms = float(np.sqrt(np.mean(cents ** 2)))
    log(f"[eval variance] the evaluation's pitch (K4, bf16) against the set's f32 pitch over "
        f"every real frame of {len(pitches)} items: max_abs_err={np.abs(cents).max():.4f} "
        f"cents rms={rms:.4f} cents (tolerance rms <= {PITCH_TOL_CENTS})")
    check.require(rms <= PITCH_TOL_CENTS, "the pitch head on K4 disagrees with its f32 modules")
    check.require(0.0 <= vreport["rhythm_corr"] <= 1.0 and 0.0 <= vreport["ph_dur_acc"] <= 1.0,
                  f"duration figures out of [0, 1]: {vreport}")
    check_ddsp(work / "ddsp")
    log(f"[timing eval] card={name_limit} evaluate_acoustic items={n} seconds={seconds:.4f} "
        f"items_per_s={n / seconds:.4f} evaluate_variance items={n} seconds={vseconds:.4f} "
        f"items_per_s={n / vseconds:.4f}")
    log(f"[done 12] {time.perf_counter() - t_phase:.1f}s")
    torch.cuda.empty_cache()
    return {k: launches[k] + vlaunches[k] for k in launches}


# ---------------------------------------------------------------------------
# training: train for the acoustic task (K1, K2, K6 in its validation) and the variance task (K4)
# ---------------------------------------------------------------------------

TRAIN_ITEMS, VALID_ITEMS = 64, 4
TRAIN_FRAMES = (400, 1300)          # 4.6-15.1 s an item at hop 512, 44.1 kHz
ACOUSTIC_STEPS, ACOUSTIC_VAL_EVERY = 30, 15
VARIANCE_STEPS, VARIANCE_VAL_EVERY = 10, 5
TRAIN_PLOTS = 2                     # num_valid_plots
STEP_LOSS_REL_F32 = 1e-4            # the card's f32 step against the CPU's
STEP_GRAD_F32 = 1e-3                # of each gradient tensor's largest CPU value
STEP_LOSS_REL_BF16 = 0.02           # the card's bf16-mixed step against the CPU's f32
STEP_GRAD_COS_BF16 = 0.99
TRAIN_MEL_SAME = 1e-5               # the extras' mel against the reloaded runner's, of its scale
CARD = "cuda"                       # the device of phase 13


class Recorder:
    """A writer for the trainer that keeps its scalars and audio arrays."""

    def __init__(self):
        self.scalars, self.figures, self.audio = [], [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def add_figure(self, tag, fig, step):
        import matplotlib.pyplot as plt

        plt.close(fig)
        self.figures.append((tag, step))

    def add_audio(self, tag, wav, step, sample_rate):
        import numpy as np

        self.audio.append((tag, np.asarray(wav).reshape(-1), step, sample_rate))

    def flush(self):
        pass


def _phrase(rng, frames: int, vocab: int):
    """Phonemes of 5-30 frames filling ``frames``: tokens, ``mel2ph``, durations."""
    import numpy as np

    dur = []
    while sum(dur) < frames:
        dur.append(int(rng.integers(5, 31)))
    dur[-1] -= sum(dur) - frames
    if dur[-1] < 1:
        dur[-2] += dur.pop()
    dur = np.asarray(dur, np.int64)
    tokens = rng.integers(1, vocab, len(dur)).astype(np.int64)
    return tokens, np.repeat(np.arange(1, len(dur) + 1), dur).astype(np.int64), dur


def acoustic_train_items(n: int, seed: int, vocab: int, mels: int = 128) -> list:
    """Acoustic items of 400-1300 frames whose mel is a learnable function
    of the phoneme (a template a token) and f0, plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(1234).uniform(-9.0, -2.0, (vocab, mels))
    items = []
    for _ in range(n):
        frames = int(rng.integers(TRAIN_FRAMES[0], TRAIN_FRAMES[1] + 1))
        tokens, mel2ph, _ = _phrase(rng, frames, vocab)
        t = np.arange(frames)
        f0 = 220.0 * 2 ** (0.3 * np.sin(t / 40.0 + rng.uniform(0, 6)))
        mel = (templates[tokens[mel2ph - 1]] + 0.5 * np.sin(np.outer(f0 / 110.0, np.arange(mels))
                                                            / 16.0)
               + 0.1 * rng.standard_normal((frames, mels)))
        items.append({"tokens": tokens, "mel2ph": mel2ph, "mel": mel.astype(np.float32),
                      "f0": f0.astype(np.float32)})
    return items


def variance_train_items(n: int, seed: int, vocab: int) -> list:
    """Variance items of 400-1300 frames: words of one or two phonemes,
    notes over the words, a base pitch from the notes and a pitch around
    it, unvoiced frames, energy and breathiness curves in dB."""
    import numpy as np

    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        frames = int(rng.integers(TRAIN_FRAMES[0], TRAIN_FRAMES[1] + 1))
        tokens, mel2ph, ph_dur = _phrase(rng, frames, vocab)
        ph2word = np.cumsum(np.r_[1, rng.uniform(size=len(tokens) - 1) < 0.6]).astype(np.int64)
        word_dur = np.bincount(ph2word, weights=ph_dur)[1:].astype(np.int64)
        note_dur = word_dur
        note_midi = rng.uniform(55, 72, len(note_dur)).astype(np.float32)
        note_rest = rng.uniform(size=len(note_dur)) < 0.1
        mel2note = np.repeat(np.arange(1, len(note_dur) + 1), note_dur).astype(np.int64)
        base = note_midi[mel2note - 1]
        t = np.arange(frames)
        items.append({
            "tokens": tokens, "ph_dur": ph_dur,
            "midi": np.round(note_midi[ph2word - 1]).astype(np.int64), "ph2word": ph2word,
            "mel2ph": mel2ph, "note_midi": note_midi, "note_rest": note_rest,
            "note_dur": note_dur, "mel2note": mel2note, "base_pitch": base,
            "pitch": (base + 0.3 * np.sin(t / 12.0)).astype(np.float32),
            "uv": rng.uniform(size=frames) < 0.1,
            "energy": (-40 + 10 * np.sin(t / 30.0)).astype(np.float32),
            "breathiness": (-60 + 8 * np.cos(t / 25.0)).astype(np.float32)})
    return items


def _write_sets(directory: Path, make, vocab: int) -> None:
    write_set(directory, "train", make(TRAIN_ITEMS, 0, vocab))
    write_set(directory, "valid", make(VALID_ITEMS, 1, vocab))


def _vocab(cfg) -> int:
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary
    from xiaoicesing_io_tpu_torch.utils.text_encoder import TokenTextEncoder

    return TokenTextEncoder(PhonemeDictionary.load(cfg["dictionary"]).phoneme_list).vocab_size


def train_leg(label: str, cfg, build, name_limit: str, expect: dict, trainer=None):
    """One ``fit`` on the card with a recording writer: the launch counters
    zeroed just before it and read just after, every update's losses and
    real frames, each validation's wall time.  Returns (trainer, launches,
    losses, frames, validations)."""
    import torch

    from xiaoicesing_io_tpu_torch.bench import check

    trainer = trainer or build(cfg, device=CARD, writer=Recorder())
    losses, frames, validations = [], [], []
    step, validate = trainer.train_step, trainer.validate

    def recorded_step(state, batch, generator):
        updated, metrics = step(state, batch, generator)
        losses.append(metrics)
        frames.append((batch["mel2ph"] > 0).sum())
        return updated, metrics

    def timed_validate(at, sanity=False):
        t0 = time.perf_counter()
        out = validate(at, sanity=sanity)
        torch.cuda.synchronize()
        validations.append((at, sanity, time.perf_counter() - t0))
        return out

    trainer.train_step, trainer.validate = recorded_step, timed_validate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    check.zero_launch_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = check.launch_counts()
    trainer.train_step, trainer.validate = step, validate
    want = {name: 0 for name, _, _ in check.counters()}
    want.update(expect)
    log(f"[train {label}] fit {seconds:.2f}s; launches {launches}; expected "
        f"{ {k: v for k, v in want.items() if v} }, every other kernel 0")
    check.check_launches(launches, want, True, f"the {label} training run")
    losses = [{k: float(v) for k, v in m.items()} for m in losses]
    frames = [int(f) for f in frames]
    bad = [m for m in losses if not all(math.isfinite(v) for v in m.values())]
    check.require(not bad, f"{label}: a loss is not finite: {bad[:3]}")
    # update times on the card's timeline; an interval that ends after a
    # validation and checkpoint is not a training step
    ms = trainer.update_ms()
    val_steps = {at for at, sanity, _ in validations if not sanity}
    # ms[i]: update first + i + 2, timed from update first + i + 1 (first: the step before
    # this fit); the first 3 updates and those right after a validation are left out
    first = trainer.state.step - len(ms) - 1
    steady = [(m, frames[i + 1]) for i, m in enumerate(ms)
              if i >= 2 and first + i + 1 not in val_steps]
    hop, sr = cfg["hop_size"], cfg["audio_sample_rate"]
    med = sorted(m for m, _ in steady)[len(steady) // 2]
    audio_sps = sum(f for _, f in steady) * hop / sr / (sum(m for m, _ in steady) / 1e3)
    val_text = " ".join(f"{at}{'(sanity)' if sanity else ''}={s:.3f}s"
                        for at, sanity, s in validations)
    log(f"[timing train {label}] card={name_limit} updates={len(losses)} "
        f"ms_per_update_median={med:.2f} (of {len(steady)} updates after the first 3, "
        f"validations left out) trained_audio_s_per_s={audio_sps:.2f} (real frames) "
        f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
        f"validation_wall {val_text} first_loss={losses[0]['total_loss']:.4f} "
        f"last_loss={losses[-1]['total_loss']:.4f}")
    return trainer, launches, losses, frames, validations


def check_train_step_card_vs_cpu(cfg, vocab: int) -> None:
    """One train step of the full-width acoustic model at B=2, T=256 from
    the same weights, batch, t and noise: the card in f32 (TF32 off) and in
    bf16-mixed against the CPU in f32, in eval mode (no dropout)."""
    import copy

    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.training.acoustic import acoustic_losses, build_acoustic
    from xiaoicesing_io_tpu_torch.training.variance import batch_tensors

    torch.manual_seed(0)
    model, core, normalizer = build_acoustic(cfg, vocab)
    # a zero-initialised output projection would leave the backbone's gradients at zero
    with torch.no_grad():
        model.backbone.output_projection.weight.normal_(0.0, 0.02)
        for block in model.aux_decoder.decoder.conv:
            block.gamma.normal_(0.0, 0.1)
    items = acoustic_train_items(2, 7, vocab)
    for it, n in zip(items, (256, 200)):
        for k in ("mel2ph", "mel", "f0"):
            it[k] = it[k][:n]
        it["tokens"] = it["tokens"][: int(it["mel2ph"].max())]
    batch_np = {"tokens": np.zeros((2, 32), np.int64), "mel2ph": np.zeros((2, 256), np.int64),
                "mel": np.zeros((2, 256, 128), np.float32), "f0": np.zeros((2, 256), np.float32)}
    for i, it in enumerate(items):
        for k, v in it.items():
            batch_np[k][i, : len(v)] = v
    g = torch.Generator().manual_seed(3)
    t = core.t_start + (1 - core.t_start) * torch.rand(2, generator=g)
    noise = torch.randn(2, 1, 256, 128, generator=g)

    def step(m, device, bf16=False):
        m.eval()
        m.zero_grad(set_to_none=True)
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            out = acoustic_losses(m, core, normalizer, cfg, batch_tensors(batch_np, device),
                                  t=t.to(device), noise=noise.to(device))
        sum(out.values()).backward()
        return ({k: float(v.detach()) for k, v in out.items()},
                {k: None if p.grad is None else p.grad.float().cpu()
                 for k, p in m.named_parameters()})

    t0 = time.perf_counter()
    ref_loss, ref_grad = step(model, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    card = copy.deepcopy(model).to(CARD)
    results = {}
    for name, bf16 in (("f32", False), ("bf16-mixed", True)):
        loss, grad = step(card, torch.device(CARD), bf16)
        rel = max(abs(loss[k] - ref_loss[k]) / abs(ref_loss[k]) for k in ref_loss)
        worst, worst_name, dot, n_got, n_ref = 0.0, None, 0.0, 0.0, 0.0
        for k, r in ref_grad.items():
            check_none = (r is None) == (grad[k] is None)
            if not check_none:
                raise AssertionError(f"{name}: gradient of {k} on one side only")
            if r is None:
                continue
            scale = float(r.abs().max())
            err = float((grad[k] - r).abs().max()) / max(scale, 1e-30)
            if err > worst:
                worst, worst_name = err, k
            dot += float((grad[k].double() * r.double()).sum())
            n_got += float((grad[k].double() ** 2).sum())
            n_ref += float((r.double() ** 2).sum())
        cos = dot / math.sqrt(n_got * n_ref)
        results[name] = (rel, worst, worst_name, cos)
        log(f"[train step {name}] full-width acoustic step B=2 T=256, card against CPU f32: "
            f"losses {loss} vs {ref_loss}, max rel err {rel:.3g}; worst gradient tensor "
            f"{worst_name} err {worst:.3g} of its scale; global gradient cosine {cos:.8f}")
    rel, worst, _, _ = results["f32"]
    check.require(rel <= STEP_LOSS_REL_F32 and worst <= STEP_GRAD_F32,
                  f"the card's f32 train step disagrees with the CPU's (tolerance: losses "
                  f"{STEP_LOSS_REL_F32} rel, gradients {STEP_GRAD_F32} of scale)")
    rel, _, _, cos = results["bf16-mixed"]
    check.require(rel <= STEP_LOSS_REL_BF16 and cos > STEP_GRAD_COS_BF16,
                  f"the card's bf16-mixed train step disagrees with the CPU's f32 (tolerance: "
                  f"losses {STEP_LOSS_REL_BF16} rel, gradient cosine > {STEP_GRAD_COS_BF16})")
    log(f"[train step] CPU f32 step {cpu_s:.2f}s; tolerances: f32 losses {STEP_LOSS_REL_F32} "
        f"rel, gradients {STEP_GRAD_F32} of each tensor's scale; bf16-mixed losses "
        f"{STEP_LOSS_REL_BF16} rel, cosine > {STEP_GRAD_COS_BF16}")
    del card
    torch.cuda.empty_cache()


def run_training(lynx_cfg, work: Path, name_limit: str, per_call: dict) -> dict:
    """Phase 13: ``train`` for the acoustic task at the shipped acoustic
    configuration and for the variance task at the shipped variance
    configuration (with energy and breathiness), on synthetic binarized sets,
    on the card; their launches, losses, held-out loss, logged audio, saved
    checkpoint and resume; one train step on the card against the CPU.
    Returns the launches of both legs."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.config import Config, variance_defaults
    from xiaoicesing_io_tpu_torch.eval.copy_synthesis import _batch_from_item
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer
    from xiaoicesing_io_tpu_torch.training.checkpoint import checkpoint_step, list_checkpoints
    from xiaoicesing_io_tpu_torch.training.tasks import (
        build_acoustic_trainer, build_variance_trainer,
    )
    from xiaoicesing_io_tpu_torch.training.variance import batch_tensors

    t_phase = time.perf_counter()
    vocab = _vocab(lynx_cfg)
    cfg = Config(lynx_cfg, binary_data_dir=str(work / "acoustic_binary"),
                 work_dir=str(work / "acoustic_exp"), max_updates=ACOUSTIC_STEPS,
                 val_check_interval=ACOUSTIC_VAL_EVERY, num_valid_plots=TRAIN_PLOTS,
                 log_interval=5)
    t0 = time.perf_counter()
    _write_sets(Path(cfg["binary_data_dir"]), acoustic_train_items, vocab)
    log(f"[train acoustic] sets written in {time.perf_counter() - t0:.1f}s: {TRAIN_ITEMS} train "
        f"and {VALID_ITEMS} valid items of {TRAIN_FRAMES[0]}-{TRAIN_FRAMES[1]} frames; "
        f"{cfg['precision']}, max_batch_frames {cfg['max_batch_frames']}, max_batch_size "
        f"{cfg['max_batch_size']}, LYNXNet {cfg['backbone_args']['num_channels']} x "
        f"{cfg['backbone_args']['num_layers']}, vocoder {cfg['vocoder_ckpt']}")
    trainer = build_acoustic_trainer(cfg, device=CARD, writer=Recorder())
    valid = trainer.valid_dataset
    held_out = batch_tensors(valid.collate(list(range(len(valid)))), trainer.device)

    @torch.no_grad()
    def held_out_loss():
        model = trainer.state.model
        model.eval()
        g = torch.Generator(device=trainer.device).manual_seed(123)
        out = trainer.val_losses_fn(held_out, g)
        model.train()
        return {k: float(v) for k, v in out.items()}

    before = held_out_loss()
    mels = []
    forward = DiffSingerAcousticInfer.forward_model

    def recorded(self, batch, seed=0, noise=None, _f32_module=False):
        out = forward(self, batch, seed=seed, noise=noise, _f32_module=_f32_module)
        mels.append((seed, out))
        return out

    layers, steps = cfg["backbone_args"]["num_layers"], cfg["sampling_steps"]
    n_val = ACOUSTIC_STEPS // ACOUSTIC_VAL_EVERY
    calls = n_val * TRAIN_PLOTS + TRAIN_PLOTS  # predictions, and the ground truth once
    expect = {"lynx_conv_module": n_val * TRAIN_PLOTS * steps * layers,
              **{k: v * calls for k, v in per_call.items()}}
    DiffSingerAcousticInfer.forward_model = recorded
    try:
        trainer, launches, losses, _, _ = train_leg("acoustic", cfg, build_acoustic_trainer,
                                                    name_limit, expect, trainer)
    finally:
        DiffSingerAcousticInfer.forward_model = forward
    after = held_out_loss()
    log(f"[train acoustic] held-out loss (the {VALID_ITEMS} valid items, fixed t and noise, "
        f"eval mode) before {before} after {after}")
    check.require(sum(after.values()) < sum(before.values()),
                  "training did not lower the held-out loss")
    writer = trainer.writer
    hop = cfg["hop_size"]
    want_tags = [f"validation/wav_{kind}_{i}" for v in range(n_val)
                 for kind in (("diff", "gt") if v == 0 else ("diff",)) for i in range(TRAIN_PLOTS)]
    check.require(sorted(t for t, _, _, _ in writer.audio) == sorted(want_tags),
                  f"logged audio {[t for t, _, _, _ in writer.audio]}")
    for tag, wav, step, _ in writer.audio:
        frames = int((valid[int(tag.rsplit("_", 1)[1])]["mel2ph"] > 0).sum())
        check.require(np.isfinite(wav).all() and wav.shape == (frames * hop,),
                      f"{tag} at step {step}: {wav.shape} samples for {frames} frames")
    log(f"[train acoustic] {len(writer.audio)} logged wavs, each finite and frames x {hop} long; "
        f"{len(writer.scalars)} scalars, {len(writer.figures)} figures")
    # the saved checkpoint through the runner, against the extras' mel of the last validation
    ckpts = [checkpoint_step(p) for p in list_checkpoints(cfg["work_dir"])]
    check.require(ckpts[-1] == ACOUSTIC_STEPS, f"checkpoints {ckpts}")
    ckpt = torch.load(list_checkpoints(cfg["work_dir"])[-1], map_location="cpu",
                      weights_only=False)
    runner = DiffSingerAcousticInfer(cfg, load_vocoder=False, device=CARD)
    item = TRAIN_PLOTS - 1
    seed, extras_mel = mels[-TRAIN_PLOTS + item]
    mel = runner.forward_model(_batch_from_item(cfg, runner, valid.collate([item])), seed=seed)
    err = float(np.abs(mel - extras_mel).max())
    scale = float(np.abs(extras_mel).max())
    log(f"[train acoustic] checkpoint {ckpts[-1]} (epoch {ckpt['epoch']}) in "
        f"DiffSingerAcousticInfer(device='cuda'): item {item}'s mel, seed {seed}, against the "
        f"extras' at step {ACOUSTIC_STEPS}: max_abs_err {err:.3g} at a scale of {scale:.4g} "
        f"(tolerance {TRAIN_MEL_SAME} of it)")
    check.require(err <= TRAIN_MEL_SAME * scale, "the reloaded runner's mel differs from the "
                  "extras'")
    del runner
    # resume: a second trainer with two more updates
    cfg2 = Config(cfg, max_updates=ACOUSTIC_STEPS + 2)
    trainer2 = build_acoustic_trainer(cfg2, device=CARD, writer=Recorder())
    first, epochs = [], []
    step2, sampler2 = trainer2.train_step, trainer2._make_sampler

    def first_step(state, batch, generator):
        first.append(state.step)
        return step2(state, batch, generator)

    def sampler(epoch):
        epochs.append(epoch)
        return sampler2(epoch)

    trainer2.train_step, trainer2._make_sampler = first_step, sampler
    trainer2.fit()
    last = torch.load(list_checkpoints(cfg["work_dir"])[-1], map_location="cpu",
                      weights_only=False)
    log(f"[train acoustic] resumed at step {first[0]} in epoch {epochs[0]} (saved: step "
        f"{ckpt['global_step']}, epoch {ckpt['epoch']}); its last checkpoint: step "
        f"{last['global_step']}, epoch {last['epoch']}")
    check.require(first[0] == ACOUSTIC_STEPS and epochs[0] == ckpt["epoch"]
                  and last["global_step"] == ACOUSTIC_STEPS + 2,
                  "the resume missed the saved step or epoch")
    del trainer, trainer2
    torch.cuda.empty_cache()
    check_train_step_card_vs_cpu(cfg, vocab)

    vcfg = variance_defaults()
    vcfg.update(dictionary=lynx_cfg["dictionary"], binary_data_dir=str(work / "variance_binary"),
                work_dir=str(work / "variance_exp"), predict_energy=True,
                predict_breathiness=True, max_updates=VARIANCE_STEPS,
                val_check_interval=VARIANCE_VAL_EVERY, num_valid_plots=TRAIN_PLOTS,
                log_interval=VARIANCE_VAL_EVERY)
    _write_sets(Path(vcfg["binary_data_dir"]), variance_train_items, vocab)
    heads = (vcfg["pitch_prediction_args"]["backbone_args"]["num_layers"]
             + vcfg["variances_prediction_args"]["backbone_args"]["num_layers"])
    vexpect = {"wavenet_block": VARIANCE_STEPS // VARIANCE_VAL_EVERY * TRAIN_PLOTS
               * vcfg["sampling_steps"] * heads}
    vtrainer, vlaunches, _, _, _ = train_leg("variance", vcfg, build_variance_trainer,
                                             name_limit, vexpect)
    metrics = vtrainer.last_metrics
    log(f"[train variance] validation metrics at step {VARIANCE_STEPS}: "
        + " ".join(f"{k}={v:.6f}" for k, v in metrics.items()))
    check.require(set(metrics) == {"rhythm_corr", "ph_dur_acc", "pitch_acc"}
                  and all(0.0 <= v <= 1.0 for v in metrics.values()), f"metrics {metrics}")
    del vtrainer
    torch.cuda.empty_cache()
    log(f"[done 13] {time.perf_counter() - t_phase:.1f}s")
    return {k: launches[k] + vlaunches[k] for k in launches}


# ---------------------------------------------------------------------------
# the JAX-checkpoint bridge: phase 13's checkpoints as JAX trees, converted back (K1, K2, K6, K4)
# ---------------------------------------------------------------------------

BRIDGE_GRAD = 1e-3                  # the fixed gradients of the resume check: N(0, 1) x this
BRIDGE_SEED = 17


def _same_bits(a, b) -> bool:
    """Two CPU tensors or numpy arrays of one dtype and shape, bit for bit
    (-0.0 is not 0.0, a NaN equals its own bits)."""
    import numpy as np

    a, b = (np.ascontiguousarray(x.numpy() if hasattr(x, "numpy") else x) for x in (a, b))
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _tensors_equal(a, b, what: str) -> int:
    """Raise unless the two state dicts hold the same names, dtypes and bits;
    returns the tensor count."""
    from xiaoicesing_io_tpu_torch.bench import check

    check.require(a.keys() == b.keys(), f"{what}: names differ: "
                  f"{sorted(set(a) ^ set(b))[:5]}")
    bad = [k for k in a if not _same_bits(a[k], b[k])]
    check.require(not bad, f"{what}: {len(bad)} tensors differ, e.g. {bad[:5]}")
    return len(a)


def _bridge_model(cfg, category: str):
    from xiaoicesing_io_tpu_torch.models.toplevel import AcousticModel, VarianceModel
    from xiaoicesing_io_tpu_torch.training.finetune import freeze_parameters

    model = (AcousticModel if category == "acoustic" else VarianceModel).from_config(
        cfg, _vocab(cfg))
    if cfg.get("freezing_enabled", False) and cfg.get("frozen_params"):
        freeze_parameters(model, cfg["frozen_params"])
    return model


def bridge_convert(cfg, out: Path, name_limit: str) -> tuple:
    """The work dir's last checkpoint as the JAX package's tree (the port's
    ``torch_ckpt`` for the params, the optax state in the layout ``cfg``
    gives), converted back by ``training/jax_bridge.py`` into ``out``; its
    weights and AdamW state must be the original's bit for bit.  Returns
    (the original's path, the converted path)."""
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.training.checkpoint import list_checkpoints, load_checkpoint
    from xiaoicesing_io_tpu_torch.training.jax_bridge import (
        convert_jax_tree, jax_tree_from_state,
    )
    from xiaoicesing_io_tpu_torch.training.train_state import TrainState

    src = list_checkpoints(cfg["work_dir"])[-1]
    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    category = ckpt["category"]
    state = TrainState(_bridge_model(cfg, category), cfg)
    load_checkpoint(src, state, expected_category=category)
    t0 = time.perf_counter()
    tree = jax_tree_from_state(state.model, state.optimizer.state_dict(), cfg)
    t_tree = time.perf_counter() - t0
    meta = {"step": ckpt["global_step"], "category": category, "epoch": ckpt["epoch"]}
    t0 = time.perf_counter()
    path = convert_jax_tree(cfg, tree, meta, out)
    t_convert = time.perf_counter() - t0
    got = torch.load(path, map_location="cpu", weights_only=False)
    n = _tensors_equal(ckpt["state_dict"], got["state_dict"], f"{category}: the weights")
    a, b = ckpt["optimizer_states"][0], got["optimizer_states"][0]
    check.require(a["param_groups"] == b["param_groups"] and a["state"].keys() == b["state"].keys(),
                  f"{category}: the AdamW param groups or states differ")
    for i in a["state"]:
        _tensors_equal(a["state"][i], b["state"][i], f"{category}: AdamW state {i}")
    check.require({k: got[k] for k in ("category", "global_step", "epoch")}
                  == {k: ckpt[k] for k in ("category", "global_step", "epoch")},
                  f"{category}: category, step or epoch differ")
    params = sum(v.numel() for v in ckpt["state_dict"].values())
    log(f"[bridge {category}] {src.name} (step {ckpt['global_step']}, epoch {ckpt['epoch']}) "
        f"as the JAX tree and back: {n} tensors ({params} values) and the AdamW state of "
        f"{len(a['state'])} parameters (step {int(next(iter(a['state'].values()))['step'])}) "
        f"equal bit for bit")
    log(f"[timing bridge {category}] card={name_limit} tree_s={t_tree:.3f} (state dict + "
        f"AdamW -> JAX layout) convert_s={t_convert:.3f} (model_from_jax with its round-trip "
        f"check, optimizer_state_from_jax, torch.save) values={params} "
        f"file_mb={path.stat().st_size / 2 ** 20:.1f}")
    return src, path


def bridge_resume(cfg, paths, category: str) -> None:
    """Two updates from each checkpoint with the same fixed gradients on the
    card: the parameters must end bit for bit equal."""
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.training.checkpoint import load_checkpoint
    from xiaoicesing_io_tpu_torch.training.train_state import TrainState

    ends = []
    for path in paths:
        state = TrainState(_bridge_model(cfg, category).to(CARD).train(), cfg)
        meta = load_checkpoint(path, state, expected_category=category)
        g = torch.Generator(device=CARD).manual_seed(BRIDGE_SEED)
        for _ in range(2):
            for p in state.params:
                p.grad = torch.randn(p.shape, generator=g, device=CARD) * BRIDGE_GRAD
            state.apply_gradients()
        ends.append({k: v.detach().cpu() for k, v in state.model.state_dict().items()})
        del state
    n = _tensors_equal(ends[0], ends[1], f"{category}: the parameters after two updates")
    saved = torch.load(paths[0], map_location="cpu", weights_only=False)["state_dict"]
    changed = sum(not torch.equal(ends[0][k.removeprefix("model.")], v) for k, v in saved.items())
    check.require(changed > 0, f"{category}: two updates changed no tensor")
    log(f"[bridge {category}] two updates on the card from each checkpoint (step "
        f"{meta['step']}, fixed N(0, 1) x {BRIDGE_GRAD} gradients, seed {BRIDGE_SEED}): "
        f"{n} tensors equal bit for bit, {changed} moved")
    torch.cuda.empty_cache()


def run_bridge(train: Path, work: Path, name_limit: str) -> dict:
    """Phase 17: phase 13's last acoustic and variance checkpoints as the JAX
    package's trees, converted back (the weights and AdamW state bit for
    bit), then the converted files on the card against the originals:
    ``infer acoustic`` on the sample's first segment (K1, K2, K6) and the
    variance heads on its bare first segment (K4), mel, wav and predictions
    bit for bit with exact launches; two resumed updates each.  Returns the
    converted runs' launches."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.config import Config, load_config
    from xiaoicesing_io_tpu_torch.inference.acoustic import DiffSingerAcousticInfer, load_ds
    from xiaoicesing_io_tpu_torch.inference.variance import DiffSingerVarianceInfer

    t_phase = time.perf_counter()
    total = {name: 0 for name, _, _ in check.counters()}

    cfg = load_config(None, exp_name="acoustic_exp", work_dir_root=train, infer=True)
    paths = bridge_convert(cfg, work / "acoustic", name_limit)
    outs = []
    for label, c in (("original", cfg), ("converted", Config(cfg, work_dir=str(work / "acoustic")))):
        runner = DiffSingerAcousticInfer(c, device=CARD)
        launches, _, rec, _ = drive_main_path(runner, work / f"acoustic_out_{label}",
                                              load_ds(ROOT / SAMPLE)[:1],
                                              f"{SAMPLE} segment 0, {label} checkpoint")
        implied = check.implied_launches(runner, 1, 1)
        check.check_launches(launches, implied, True, f"the {label} checkpoint's segment")
        outs.append(([np.asarray(m) for _, _, m in rec["segment"]],
                     [np.asarray(w) for _, _, w in rec["vocoder"]]))
        if label == "converted":
            total = {k: total[k] + launches[k] for k in total}
            log(f"[bridge acoustic] converted checkpoint: launches {launches}; expected "
                f"{ {k: v for k, v in implied.items() if v} }, every other kernel 0")
        del runner
        torch.cuda.empty_cache()
    same = all(_same_bits(a, b) for a, b in zip(outs[0][0] + outs[0][1],
                                                outs[1][0] + outs[1][1]))
    check.require(same and len(outs[0][0]) == len(outs[1][0]) == 1,
                  "the converted checkpoint's mel or wav differs from the original's")
    log(f"[bridge acoustic] mel {outs[0][0][0].shape} and wav {outs[0][1][0].shape} of the "
        f"converted checkpoint equal the original's bit for bit (seed 0)")
    bridge_resume(cfg, paths, "acoustic")

    vcfg = load_config(None, exp_name="variance_exp", work_dir_root=train, infer=True)
    vpaths = bridge_convert(vcfg, work / "variance", name_limit)
    drop = {"ph_dur", "f0_seq", "f0_timestep", *CURVES, *(f"{v}_timestep" for v in CURVES)}
    seg = {k: v for k, v in load_ds(ROOT / SAMPLE)[0].items() if k not in drop}
    vouts = []
    for label, c in (("original", vcfg),
                     ("converted", Config(vcfg, work_dir=str(work / "variance")))):
        runner = DiffSingerVarianceInfer(c, device=CARD)
        flags = runner.segment_flags(seg)
        check.require(flags == (True, True, True), f"flags {flags}")
        batch = runner.preprocess_input(seg)
        layers = {h: len(b.residual_layers) for h, b in runner.heads().items()}
        want = {name: 0 for name, _, _ in check.counters()}
        want["wavenet_block"] = check.sampler_steps(runner) * sum(layers.values())
        check.zero_launch_counts()
        out = runner.forward_model(batch, flags, seed=0)
        torch.cuda.synchronize()
        launches = check.launch_counts()
        check.check_launches(launches, want, True, f"the {label} variance checkpoint")
        vouts.append(out)
        if label == "converted":
            total = {k: total[k] + launches[k] for k in total}
            log(f"[bridge variance] converted checkpoint, bare segment 0 of {SAMPLE}: "
                f"launches {launches}; expected wavenet_block {check.sampler_steps(runner)} "
                f"steps x ({' + '.join(f'{h} {k}' for h, k in layers.items())} layers)")
        del runner
        torch.cuda.empty_cache()
    (da, pa, va), (db, pb, vb) = vouts
    check.require(_same_bits(da, db) and _same_bits(pa, pb) and va.keys() == vb.keys()
                  and all(_same_bits(va[k], vb[k]) for k in va),
                  "the converted variance checkpoint's predictions differ from the original's")
    log(f"[bridge variance] durations, pitch {np.asarray(pa).shape} and {sorted(va)} of the "
        f"converted checkpoint equal the original's bit for bit (seed 0)")
    bridge_resume(vcfg, vpaths, "variance")
    log(f"[done 17] {time.perf_counter() - t_phase:.1f}s")
    return total


# ---------------------------------------------------------------------------
# binarization: raw wavs + transcriptions.csv -> binarized sets (no kernel; RMVPE and the
# vocal-remover net on the card)
# ---------------------------------------------------------------------------

BIN_SPEAKERS = ("spk_a", "spk_b")
BIN_ITEMS = 6                        # a speaker
BIN_SECONDS = (3.0, 8.0)
BIN_SR = 44100
VR_WIDTHS = dict(n_fft=2048, hop_length=512, n_out=32, n_out_lstm=128, is_mono=False)
NET_CARD_VS_CPU = 1e-4               # RMVPE's salience and the VR mask, absolute, TF32 off
BIN_STAGES = ("load", "mel", "pitch", "separation", "curves", "augmentation", "write")


def raw_singing_set(root: Path, dictionary, seed: int = 0) -> list:
    """Two speakers' raw sets of sung phrases: every phone of ``dictionary``
    in turn, 0.08-0.25 s each, words of one or two phones under one note
    (C3-B4; rests on AP and SP), the wav a harmonic tone along the notes with
    5.5 Hz vibrato and white noise 40 dB below it; ``transcriptions.csv`` with
    ``ph_seq``, ``ph_dur``, ``ph_num``, ``note_seq`` and ``note_dur``.
    Returns the wav paths."""
    import numpy as np

    from xiaoicesing_io_tpu_torch.utils.audio import save_wav
    from xiaoicesing_io_tpu_torch.utils.music import midi_to_hz, midi_to_note
    from xiaoicesing_io_tpu_torch.utils.phonemes import PhonemeDictionary

    rng = np.random.default_rng(seed)
    phones = [p for p in PhonemeDictionary.load(dictionary).phoneme_list if p not in ("AP", "SP")]
    cursor, wavs = 0, []
    for spk in BIN_SPEAKERS:
        (root / spk / "wavs").mkdir(parents=True)
        rows = ["name,ph_seq,ph_dur,ph_num,note_seq,note_dur"]
        for i in range(BIN_ITEMS):
            seconds = float(rng.uniform(*BIN_SECONDS))
            ph_seq, ph_dur = ["SP"], [0.3]
            while sum(ph_dur) < seconds - 0.5:
                ph_seq.append(phones[cursor % len(phones)])
                ph_dur.append(round(float(rng.uniform(0.08, 0.25)), 4))
                cursor += 1
            ph_seq.append("AP" if i % 2 else "SP")
            ph_dur.append(round(seconds - sum(ph_dur), 4))
            words, k = [1], 1  # the leading SP, words of 1-2 phones, the tail
            while k < len(ph_seq) - 1:
                words.append(min(int(rng.integers(1, 3)), len(ph_seq) - 1 - k))
                k += words[-1]
            words.append(1)
            bounds = np.cumsum([0] + words)
            midis = [None if ph_seq[a] in ("AP", "SP") else int(rng.integers(48, 72))
                     for a in bounds[:-1]]
            note_dur = [round(sum(ph_dur[a:b]), 4) for a, b in zip(bounds[:-1], bounds[1:])]
            n = int(sum(ph_dur) * BIN_SR)
            t = np.arange(n) / BIN_SR
            idx = np.minimum(np.searchsorted(np.cumsum(note_dur) * BIN_SR, np.arange(n),
                                             side="right"), len(midis) - 1)
            midi = np.array([60 if m is None else m for m in midis], np.float64)[idx]
            f0 = midi_to_hz(midi) * 2.0 ** (0.3 * np.sin(2 * np.pi * 5.5 * t) / 12)
            phase = 2 * np.pi * np.cumsum(f0) / BIN_SR
            x = sum(np.sin(k * phase) / k for k in range(1, 9))
            x = 0.5 * x / np.abs(x).max() * np.where(
                np.array([m is None for m in midis])[idx], 0.02, 1.0)
            x += rng.standard_normal(n) * np.sqrt(np.mean(x ** 2)) * 10 ** (-40 / 20)
            name = f"{spk}_{i:02d}"
            wavs.append(root / spk / "wavs" / f"{name}.wav")
            save_wav(x.astype(np.float32), wavs[-1], BIN_SR)
            rows.append(",".join([
                name, " ".join(ph_seq), " ".join(f"{d:.4f}" for d in ph_dur),
                " ".join(map(str, words)),
                " ".join("rest" if m is None else midi_to_note(m) for m in midis),
                " ".join(f"{d:.4f}" for d in note_dur)]))
        (root / spk / "transcriptions.csv").write_text("\n".join(rows) + "\n")
    return wavs


def binarization_nets(work: Path, device: str, vr_widths: dict) -> tuple:
    """Random full-width RMVPE (``E2E0()``) and vocal remover (``CascadedNet``
    at ``vr_widths``, written into its ``config.yaml``) under the reference
    names, with random BatchNorm statistics; -> (pe_ckpt, hnsep_ckpt)."""
    import torch
    import yaml

    from xiaoicesing_io_tpu_torch.models.hnsep_vr import CascadedNet
    from xiaoicesing_io_tpu_torch.models.pe.rmvpe import E2E0

    torch.manual_seed(14)
    work.mkdir(parents=True, exist_ok=True)
    nets = (E2E0(), CascadedNet(vr_widths["n_fft"], nout=vr_widths["n_out"],
                                nout_lstm=vr_widths["n_out_lstm"],
                                is_mono=vr_widths["is_mono"]))
    with torch.no_grad():
        for net in nets:
            for m in net.modules():
                if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                    m.weight.uniform_(0.5, 1.5)
                    m.bias.normal_(0.0, 0.1)
                    m.running_mean.normal_(0.0, 0.1)
                    m.running_var.uniform_(0.5, 1.5)
    torch.save({"model": nets[0].state_dict()}, work / "rmvpe.pt")
    (work / "vr").mkdir()
    torch.save(nets[1].state_dict(), work / "vr" / "model.pt")
    (work / "vr" / "config.yaml").write_text(yaml.safe_dump(vr_widths))
    return str(work / "rmvpe.pt"), str(work / "vr" / "model.pt")


def binarize_leg(label: str, cls, cfg, device: str, raw_items: int, name_limit: str) -> tuple:
    """One binarization with the launch counters zeroed just before it and
    read just after (binarization launches no kernel); every written item
    finite and its frame arrays of one length.  -> (binarizer, train and
    valid items, launches)."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.data.indexed_dataset import IndexedDataset

    on_card = device != "cpu"
    held = 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    check.zero_launch_counts()
    t0 = time.perf_counter()
    binarizer = cls(cfg, device=device)
    binarizer.process()
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = check.launch_counts()
    check.check_launches(launches, {name: 0 for name, _, _ in check.counters()}, on_card,
                         f"the {label} binarization")
    out = Path(cfg["binary_data_dir"])
    items = {p: [IndexedDataset(out, p)[i] for i in range(len(IndexedDataset(out, p)))]
             for p in ("train", "valid")}
    written = sum(len(v) for v in items.values())
    frame_keys = ("mel", "mel2ph", "f0", "mel2note", "base_pitch", "pitch", "uv", "energy",
                  "breathiness", "voicing", "tension")
    for it in items["train"] + items["valid"]:
        bad = [k for k, v in it.items() if np.issubdtype(np.asarray(v).dtype, np.floating)
               and not np.isfinite(v).all()]
        check.require(not bad, f"{label}: non-finite {bad}")
        lengths = {np.asarray(it[k]).shape[0] for k in frame_keys if k in it}
        check.require(len(lengths) == 1, f"{label}: frame arrays of lengths {lengths}")
    audio = sum(float(np.asarray(it["mel2ph"]).shape[0]) for it in items["train"] + items["valid"]
                ) * cfg["hop_size"] / cfg["audio_sample_rate"]
    stages = " ".join(f"{k}={binarizer.stage_seconds.get(k, 0.0):.3f}s" for k in BIN_STAGES)
    # the binarization's own peak, above what earlier phases still hold
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30 if on_card else float("nan")
    log(f"[binarize {label}] card={name_limit} {seconds:.2f}s: {raw_items} raw items -> "
        f"{written} written ({len(items['train'])} train, {len(items['valid'])} valid, "
        f"{audio:.1f} s of audio); raw_items_per_s={raw_items / seconds:.4f} "
        f"written_items_per_s={written / seconds:.4f}; stages {stages}; "
        f"peak_mem_gib={peak:.3f} (above {held / 2 ** 30:.3f} held before); launches "
        f"{launches} (binarization launches no kernel)")
    return binarizer, items, launches


def check_nets_card_vs_cpu(binarizer, wav_path: Path, device: str) -> None:
    """RMVPE's salience and the VR mask of one item on the card against the
    same modules on the CPU, from the same mel and spectrogram (f32, TF32 off
    on the card)."""
    import copy

    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.dsp.hnsep import vocal_remover
    from xiaoicesing_io_tpu_torch.utils import exact_f32
    from xiaoicesing_io_tpu_torch.utils.audio import load_wav

    wav, _ = load_wav(wav_path, sr=BIN_SR, mono=True)
    rmvpe = binarizer.pitch_extractor
    mel, frames = rmvpe.mel_frames(wav, BIN_SR)
    vr = vocal_remover(binarizer.cfg["hnsep_ckpt"], device)
    ri = vr.spectrogram(wav)[-1]
    for name, card_fn, module, x, cpu_x in (
            ("rmvpe_salience", rmvpe.salience, rmvpe.load(), mel,
             torch.from_numpy(np.ascontiguousarray(mel.T[None]))),
            ("vr_mask", vr.mask, vr.model, ri, torch.from_numpy(ri))):
        t0 = time.perf_counter()
        got = card_fn(x)
        card_s = time.perf_counter() - t0
        with torch.no_grad(), exact_f32():
            ref = copy.deepcopy(module).cpu()(cpu_x).numpy().reshape(got.shape)
        err = float(np.abs(got - ref).max())
        log(f"[binarize nets] {name} {tuple(got.shape)} of {wav_path.name} "
            f"({len(wav) / BIN_SR:.2f} s, {frames} mel frames): card against CPU max_abs_err "
            f"{err:.3g}, max_abs {float(np.abs(ref).max()):.4g} (tolerance {NET_CARD_VS_CPU}); "
            f"card call {card_s * 1e3:.1f} ms")
        check.require(err <= NET_CARD_VS_CPU, f"{name}: the card disagrees with the CPU")


def run_binarization(lynx_cfg, work: Path, name_limit: str, device: str = "cuda",
                     vr_widths: dict = VR_WIDTHS) -> dict:
    """Phase 14: ``binarize`` through the port's binarizers on a synthetic raw
    set.  The acoustic binarizer at the shipped settings (``pe:
    parselmouth``, ``hnsep: world``) with the four curves and both
    augmentations, its set read back through ``AcousticDataset``; the
    variance binarizer with ``pe: rmvpe`` and ``hnsep: vr`` on random
    full-width nets on the card, and those nets on the card against the
    CPU.  Returns the launches of both binarizations (all 0)."""
    import numpy as np

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.config import acoustic_defaults, variance_defaults
    from xiaoicesing_io_tpu_torch.data.dataset import AcousticDataset
    from xiaoicesing_io_tpu_torch.preprocessing.acoustic_binarizer import AcousticBinarizer
    from xiaoicesing_io_tpu_torch.preprocessing.variance_binarizer import VarianceBinarizer

    t_phase = time.perf_counter()
    dictionary = lynx_cfg["dictionary"]
    wavs = raw_singing_set(work / "raw", dictionary)
    raw = dict(raw_data_dir=[str(work / "raw" / s) for s in BIN_SPEAKERS],
               speakers=list(BIN_SPEAKERS), num_spk=len(BIN_SPEAKERS), dictionary=dictionary,
               test_prefixes=[f"{s}_00" for s in BIN_SPEAKERS])
    log(f"[binarize] raw set: {len(wavs)} items of {BIN_SECONDS[0]}-{BIN_SECONDS[1]} s at "
        f"{BIN_SR} Hz, {len(BIN_SPEAKERS)} speakers, every phone of {dictionary}; "
        f"{time.perf_counter() - t_phase:.1f}s")

    random.seed(0)
    cfg = acoustic_defaults()
    cfg.update(raw, binary_data_dir=str(work / "acoustic"), use_energy_embed=True,
               use_breathiness_embed=True, use_voicing_embed=True, use_tension_embed=True,
               use_key_shift_embed=True, use_speed_embed=True)
    cfg["augmentation_args"] = dict(
        cfg["augmentation_args"],
        random_pitch_shifting=dict(cfg["augmentation_args"]["random_pitch_shifting"],
                                   enabled=True),
        random_time_stretching=dict(cfg["augmentation_args"]["random_time_stretching"],
                                    enabled=True))
    _, items, launches = binarize_leg(f"acoustic pe={cfg['pe']} hnsep={cfg['hnsep']}",
                                      AcousticBinarizer, cfg, device, len(wavs), name_limit)
    check.require(any(float(it["key_shift"]) != 0 for it in items["train"])
                  and any(float(it["speed"]) != 1 for it in items["train"]),
                  "no augmented item was written")
    dataset = AcousticDataset(cfg["binary_data_dir"], "train", cfg)
    batch = dataset.collate(list(range(4)))
    check.require(all(np.isfinite(v).all() for v in batch.values() if v.dtype.kind == "f"),
                  "the collated batch is not finite")
    log(f"[binarize acoustic] read back through AcousticDataset: {len(dataset)} train items; "
        f"one batch of 4: " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items()))

    pe_ckpt, hnsep_ckpt = binarization_nets(work / "nets", device, vr_widths)
    vcfg = variance_defaults()
    vcfg.update(raw, binary_data_dir=str(work / "variance"), predict_energy=True,
                predict_breathiness=True, predict_voicing=True, predict_tension=True,
                pe="rmvpe", pe_ckpt=pe_ckpt, hnsep="vr", hnsep_ckpt=hnsep_ckpt)
    log(f"[binarize variance] random nets: E2E0() at its defaults; CascadedNet "
        f"{vr_widths} (the released config.yaml is not in the repository)")
    binarizer, _, vlaunches = binarize_leg("variance pe=rmvpe hnsep=vr", VarianceBinarizer,
                                           vcfg, device, len(wavs), name_limit)
    check_nets_card_vs_cpu(binarizer, min(wavs, key=lambda p: p.stat().st_size), device)
    log(f"[done 14] {time.perf_counter() - t_phase:.1f}s")
    return {k: launches[k] + vlaunches[k] for k in launches}


# ---------------------------------------------------------------------------
# serving: run_inference(data_parallel=True), bucket-batched (K1 or K4; K2, K6)
# ---------------------------------------------------------------------------

SERVE_TIMING = "samples/02_一半一半.ds"
SERVE_MAX_CHUNK = (64, 768)    # the most rows of a chunk (64 x 768 = 49152 frames a call)


@contextlib.contextmanager
def wrapped_calls(targets, wrap):
    """For the length of the block each call ``object.attribute`` of
    ``targets`` (``(label, object, attribute)``) runs as
    ``wrap(label)(call)``."""
    from xiaoicesing_io_tpu_torch.bench.trace import _wrapped

    undo = [_wrapped(obj, attr, wrap(label)) for label, obj, attr in targets]
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


def record_serving():
    """For the length of the block, record what ``DataParallelSynthesizer``
    returns (``synthesize_mels``: mels and f0s; ``vocode``: wavs) and the
    song's wav as it goes to ``save_wav``.  -> (context, record)."""
    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer
    from xiaoicesing_io_tpu_torch.utils import audio

    rec = {}

    def keep(name):
        def wrap(fn):
            def recorded(*args, **kwargs):
                out = fn(*args, **kwargs)
                rec[name] = (args, out)
                return out
            return recorded
        return wrap
    targets = (("mels", DataParallelSynthesizer, "synthesize_mels"),
               ("wavs", DataParallelSynthesizer, "vocode"), ("song", audio, "save_wav"))
    return wrapped_calls(targets, keep), rec


def serve_syncs(runner, params) -> str:
    """The synchronising CUDA calls ``synthesize_mels`` makes on ``params``
    (``torch.cuda.set_sync_debug_mode``), counted by the innermost line of
    the port's code that made them; a warning raised outside the port (the
    switch of the debug mode itself can raise one) is counted apart."""
    import collections
    import traceback
    import warnings

    import torch

    from xiaoicesing_io_tpu_torch.bench.cells import _silent
    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer

    where, outside = collections.Counter(), collections.Counter()

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith("warnings.py")]
            ours = [f for f in stack if "xiaoicesing_io_tpu_torch" in f.filename]
            if ours:
                where[f"{Path(ours[-1].filename).name}:{ours[-1].lineno} ({ours[-1].line})"] += 1
            else:
                outside[" < ".join(f"{Path(f.filename).name}:{f.lineno} ({f.line})"
                                   for f in reversed(stack[-2:]))] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _silent(DataParallelSynthesizer(runner).synthesize_mels, params, seed=1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return (f"{sum(where.values())} {dict(where)}; outside the port's code: "
            f"{sum(outside.values())} {dict(outside)}")


def stage_clock(targets):
    """For the length of the block, host seconds spent in each call of
    ``targets`` (``(label, object, attribute)``), summed by label.
    -> (context, seconds)."""
    import collections

    seconds = collections.defaultdict(float)

    def clock(label):
        def wrap(fn):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    seconds[label] += time.perf_counter() - t0
            return timed
        return wrap
    return wrapped_calls(targets, clock), seconds


def check_serving(label: str, runner, work: Path, name_limit: str) -> dict:
    """Phase 15 on one experiment: the sample ``.ds`` through
    ``run_inference(data_parallel=True)`` with the launch counters zeroed
    just before it and read just after.  The denoiser's kernel must launch
    once per layer per step per chunk, K2 and K6 one vocoder call's worth
    per length group, nothing else; each segment's mel must be within
    ``bench/check.py``'s bars of the segment run alone through the kernel
    path from the same noise row; each wav finite and frames x hop long, the
    song its segments placed; ``vocode``'s groups as
    :func:`check_vocode_groups` holds them.  Returns the launches."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.bench import check, reference
    from xiaoicesing_io_tpu_torch.bench.cells import _silent
    from xiaoicesing_io_tpu_torch.inference.acoustic import load_ds
    from xiaoicesing_io_tpu_torch.inference.serving import plan_chunks
    from xiaoicesing_io_tpu_torch.utils import generator_from_seed

    params = load_ds(ROOT / SAMPLE)
    batches = [_silent(runner.preprocess_input, p) for p in params]
    lengths = [b["mel2ph"].shape[1] for b in batches]
    plan = plan_chunks(lengths)
    groups = len(set(lengths))
    implied = check.implied_launches(runner, len(plan), groups)
    hooks, rec = record_serving()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    check.zero_launch_counts()
    t0 = time.perf_counter()
    with hooks:
        _silent(runner.run_inference, params, out_dir=work, title="serve", seed=0,
                data_parallel=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = check.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    log(f"[serve {label}] {SAMPLE}: {len(params)} segments in buckets "
        f"{[(b, len(i)) for b, _, i in plan]} -> {len(plan)} chunks, {groups} vocoder groups "
        f"(distinct lengths); launches {launches}; expected "
        f"{ {k: v for k, v in implied.items() if v} } (layers x steps x chunks; per group's "
        f"vocoder call {check.vocoder_calls(runner.vocoder)}), every other kernel 0")
    check.check_launches(launches, implied, True, f"the {label} serving run")

    mels, f0s = rec["mels"][1]
    wavs = rec["wavs"][1]
    hop, sr, bins = (runner.cfg["hop_size"], runner.cfg["audio_sample_rate"],
                     runner.cfg["audio_num_mel_bins"])
    for n, mel, wav in zip(lengths, mels, wavs, strict=True):
        check.require(mel.shape == (n, bins) and wav.shape == (n * hop,)
                      and bool(np.isfinite(wav).all()),
                      f"a segment of {n} frames gave mel {mel.shape}, wav {wav.shape}")
    song = np.asarray(rec["song"][0][0])
    placed = reference.place(wavs, [p.get("offset", 0.0) for p in params], sr)
    check.require(song.shape == placed.shape and np.abs(song - placed).max() < 1e-9,
                  "the song's wav is not its segments' wavs placed at their offsets")

    worst = {"mel_rel_err": 0.0, "mel_corr": 1.0}
    for bucket, chunk_no, idxs in plan:  # each chunk's noise, drawn as the chunk drew it
        noise = torch.randn((len(idxs), 1, bucket, bins), device=runner.device,
                            generator=generator_from_seed(0, runner.device,
                                                          salt=bucket * 4099 + chunk_no))
        for row, i in enumerate(idxs):
            alone = runner.forward_model(batches[i], noise=noise[row:row + 1].cpu().numpy())
            got = check.compare_mel(mels[i], alone[0])
            check.require(got["mel_ok"], f"segment {i}: the batched mel disagrees with the "
                                         f"segment alone: {got}")
            worst["mel_rel_err"] = max(worst["mel_rel_err"], got["mel_rel_err"])
            worst["mel_corr"] = min(worst["mel_corr"], got["mel_corr"])
    check_vocode_groups(f"serve {label}", runner, mels, f0s)
    audio = sum(lengths) * hop / sr
    log(f"[serve {label}] card={name_limit} {seconds:.3f}s for {audio:.2f} s of audio "
        f"({audio / seconds:.4f} audio-s/s, one run, wav written); peak_mem_gib={peak:.3f} "
        f"(above {held / 2 ** 30:.3f} held); each segment against itself alone on the kernel "
        f"path, same noise row: worst mel rel err {worst['mel_rel_err']:.6g}, corr "
        f"{worst['mel_corr']:.8f} (tolerance: {check.tolerance_text()}); every wav finite, "
        f"frames*{hop} samples, the song its segments placed")
    log(f"[serve {label} syncs] synchronising CUDA calls in synthesize_mels: "
        f"{serve_syncs(runner, params)}")
    return launches


def vocoder_row_launches(vocoder, mel, f0):
    """One vocoder call on the stacked rows ``mel`` ``[B, T, M]`` (a serving
    group) with each K2 and K6 launch rerun on each row alone.  A row's
    products accumulate in the same order wherever its tiles fall, so each
    rerun must give its row of the batched launch bit for bit.  -> (largest
    difference, launches checked), by kernel."""
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_resblock as K6
    from xiaoicesing_io_tpu_torch.ops.cuda import hifigan_stage as K2

    worst = {"fused_resblock_stage": 0.0, "resblock_unit": 0.0}
    checked = dict.fromkeys(worst, 0)

    def by_row(name):
        def wrap(launch):
            def rerun(x, *args):
                out = launch(x, *args)
                for r in range(x.shape[0]):
                    alone = launch(x[r:r + 1].clone(), *args)
                    diff = (alone.float() - out[r:r + 1].float()).abs().max().item()
                    worst[name] = max(worst[name], diff)
                checked[name] += 1
                return out
            return rerun
        return wrap
    with wrapped_calls((("fused_resblock_stage", K2, "_launch"),
                        ("resblock_unit", K6, "_launch")), by_row):
        vocoder.spec2wav_torch(mel, f0)
    return worst, checked


def check_vocode_groups(label: str, runner, mels, f0s) -> None:
    """``DataParallelSynthesizer.vocode`` with the deterministic source
    (``seed=None``): each group of equal-length mels is one vocoder call, so
    K2 and K6 run at B > 1 with T off the tile.  Each wav is held against its
    mel vocoded alone (``run_vocoder``) at ``bench/check.py``'s wav bar, and
    the largest group of 2-4 rows goes through :func:`vocoder_row_launches`,
    which must find every K2 and K6 launch bit for bit its rows alone."""
    import collections

    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer

    wavs = DataParallelSynthesizer(runner).vocode(mels, f0s, seed=None)
    sizes = collections.Counter(m.shape[0] for m in mels)
    worst = {"wav_max_abs_err": 0.0, "wav_corr": 1.0}
    for i, (mel, f0, wav) in enumerate(zip(mels, f0s, wavs, strict=True)):
        got = check.compare_wav(wav, runner.run_vocoder(mel[None], f0[None], seed=None))
        check.require(got["wav_ok"], f"segment {i} ({mel.shape[0]} frames, in a vocoder group "
                                     f"of {sizes[mel.shape[0]]}): the grouped wav disagrees "
                                     f"with its mel vocoded alone: {got}")
        worst["wav_max_abs_err"] = max(worst["wav_max_abs_err"], got["wav_max_abs_err"])
        worst["wav_corr"] = min(worst["wav_corr"], got["wav_corr"])
    log(f"[{label} vocode groups] {len(mels)} mels in {len(sizes)} groups of sizes "
        f"{sorted(sizes.values(), reverse=True)}; each grouped wav against its mel vocoded "
        f"alone, seed None: worst max abs err {worst['wav_max_abs_err']:.6g}, corr "
        f"{worst['wav_corr']:.8f} (tolerance: wav corr > {check.WAV_TOL_CORR})")
    n = max((n for n, k in sizes.items() if 2 <= k <= 4), key=sizes.get, default=None)
    if n is None:
        return
    idxs = [i for i, m in enumerate(mels) if m.shape[0] == n]
    dev = runner.device
    diff, checked = vocoder_row_launches(
        runner.vocoder, torch.as_tensor(np.stack([mels[i] for i in idxs]), device=dev),
        torch.as_tensor(np.stack([f0s[i] for i in idxs]), device=dev))
    check.require(all(checked.values()) and not any(diff.values()),
                  f"a K2 or K6 launch on a group of {len(idxs)} rows of {n} frames differs "
                  f"from the launch on a row alone: {diff} over {checked} launches")
    log(f"[{label} vocoder rows] group of {len(idxs)} x {n} frames: each K2 and K6 launch "
        f"rerun on each row alone, bit for bit the batched launch's row ({checked} launches, "
        f"largest difference {diff})")


def check_serve_max_chunk() -> None:
    """K1 and K4 at the largest chunk serving sends them (64 x 768 frames)
    against their plain versions."""
    import torch

    from xiaoicesing_io_tpu_torch.ops.cuda import lynx_conv as K1
    from xiaoicesing_io_tpu_torch.ops.cuda import wavenet_block as K4

    B, T = SERVE_MAX_CHUNK
    x, params = k1_inputs(B, T, seed=1)
    got = K1.lynx_conv_module(x, K1.prepare_weights(*params), kernel_size=31)
    torch.cuda.synchronize()
    compare(f"K1 lynx_conv_module at the largest serving chunk [B={B},T={T}]", got,
            K1.lynx_conv_module_plain(x, *params, kernel_size=31))
    del x, params, got
    y, cond, params = k4_inputs(B, T, seed=1)
    got = K4.wavenet_block(y, cond, K4.prepare_weights(*params), dilation=8)
    torch.cuda.synchronize()
    compare(f"K4 wavenet_block at the largest serving chunk [B={B},T={T},d=8]", got,
            K4.wavenet_block_plain(y, cond, *params, dilation=8))
    del y, cond, params, got
    torch.cuda.empty_cache()


def serve_timing(runner, work: Path, name_limit: str) -> None:
    """``SERVE_TIMING`` through ``run_inference``, serial and
    ``data_parallel=True``: a warm-up of dp (the serial path has run since
    phase 6), then in turns (serial, dp, dp, serial); audio-s/s of each
    run, chunks, vocoder calls, peak memory,
    and the host seconds of each run's stages (preprocessing, synthesis,
    vocoder; the rest is placement, crossfades and the wav's write).  The
    synthesis and vocoder calls end in a host fetch, so the clock adds no
    synchronisation."""
    import torch

    from xiaoicesing_io_tpu_torch.bench.cells import _silent
    from xiaoicesing_io_tpu_torch.inference.acoustic import load_ds
    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer, plan_chunks

    params = load_ds(ROOT / SERVE_TIMING)
    lengths = [_silent(runner.preprocess_input, p)["mel2ph"].shape[1] for p in params]
    audio = sum(lengths) * runner.cfg["hop_size"] / runner.cfg["audio_sample_rate"]
    plan = plan_chunks(lengths)
    stages = {False: (("preprocess", runner, "preprocess_input"),
                      ("synthesis", runner, "forward_model"),
                      ("vocoder", runner, "run_vocoder")),
              True: (("preprocess", runner, "preprocess_input"),
                     ("synthesis", DataParallelSynthesizer, "synthesize_mels"),
                     ("vocoder", DataParallelSynthesizer, "vocode"))}
    rates = {False: [], True: []}
    splits, peaks = {}, {}
    for dp in (True, False, True, True, False):
        clock, seconds = stage_clock(stages[dp])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with clock:
            _silent(runner.run_inference, params, out_dir=work, title="timing", seed=0,
                    data_parallel=dp)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        rates[dp].append(audio / total)
        splits[dp] = dict(seconds, rest=total - sum(seconds.values()))
        peaks[dp] = max(peaks.get(dp, 0.0), (torch.cuda.max_memory_allocated() - held) / 2 ** 30)

    def split(dp):
        return " ".join(f"{k}={v:.3f}s" for k, v in splits[dp].items())
    serial, dp = rates[False], rates[True][1:]
    log(f"[serve timing] card={name_limit} {SERVE_TIMING}: {len(params)} segments, "
        f"{audio:.2f} s of audio; serial run_inference: {len(params)} synthesis and "
        f"{len(params)} vocoder calls, audio_s_per_s {' '.join(f'{r:.4f}' for r in serial)}, "
        f"peak_mem_gib {peaks[False]:.3f}, last run {split(False)}; data_parallel=True: "
        f"{len(plan)} chunks {[(b, len(i)) for b, _, i in plan]}, {len(set(lengths))} vocoder "
        f"calls, audio_s_per_s {' '.join(f'{r:.4f}' for r in dp)}, peak_mem_gib "
        f"{peaks[True]:.3f}, last run {split(True)}; dp / serial {sum(dp) / sum(serial):.4f} "
        f"(one run each in turns after a dp warm-up at {rates[True][0]:.4f}; wavs written)")


def check_timing_vocode(runner) -> None:
    """:func:`check_vocode_groups` on ``SERVE_TIMING``'s mels: 58 segments
    in 19 lengths, so larger vocoder groups than the sample's."""
    from xiaoicesing_io_tpu_torch.bench.cells import _silent
    from xiaoicesing_io_tpu_torch.inference.acoustic import load_ds
    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer

    params = load_ds(ROOT / SERVE_TIMING)
    mels, f0s = _silent(DataParallelSynthesizer(runner).synthesize_mels, params, seed=0)
    check_vocode_groups("serve timing", runner, mels, f0s)


def run_serving(lynx_runner, wavenet_runner, work: Path, name_limit: str) -> dict:
    """Phase 15: :func:`check_serving` on the experiments of phases 6 and 7,
    K1 and K4 at the largest serving chunk, the serial-vs-dp timing on
    ``SERVE_TIMING`` (LYNXNet) with its ``vocode`` groups checked, and the
    deployment benchmarks at their defaults.  Returns the serving runs' launches, summed."""
    from xiaoicesing_io_tpu_torch.deployment.benchmarks import bench_acoustic, bench_vocoder

    t_phase = time.perf_counter()
    lynx = check_serving("lynx_reflow", lynx_runner, work / "lynx", name_limit)
    wavenet = check_serving("wavenet_ddpm", wavenet_runner, work / "wavenet", name_limit)
    check_serve_max_chunk()
    serve_timing(lynx_runner, work / "timing", name_limit)
    check_timing_vocode(lynx_runner)
    acoustic_s = bench_acoustic(lynx_runner.cfg, device="cuda")
    vocoder_s = bench_vocoder(device="cuda")
    log(f"[deploy bench] card={name_limit} bench_acoustic (LYNXNet 1024 x 6, reflow, 10 tokens, "
        f"100 frames, 20 steps, bf16 modules): {acoustic_s * 1e3:.4f} ms/run; bench_vocoder "
        f"(shipped NSF-HiFiGAN, 1000 frames, bf16 stock generator): {vocoder_s * 1e3:.4f} "
        f"ms/run (20 runs each after a warm-up)")
    log(f"[done 15] {time.perf_counter() - t_phase:.1f}s")
    return {k: lynx[k] + wavenet[k] for k in lynx}


# ---------------------------------------------------------------------------
# export: ONNX graphs of the phase 6 and 7b experiments against the card (K1, K2, K6, K4)
# ---------------------------------------------------------------------------

EXPORT_STEPS = 4        # Euler steps of the acoustic graph (the numpy executor is slow)
EXPORT_SEED = 16        # the executor's noise


def graph_stats(path: Path) -> tuple:
    """(the parsed graph, MB on disk, node count with the Loop bodies')."""
    from xiaoicesing_io_tpu_torch.deployment.onnx_proto import parse_model

    data = path.read_bytes()
    graph, _ = parse_model(data)

    def count(g):
        return sum(1 + sum(count(v) for v in n.attrs.values() if hasattr(v, "nodes"))
                   for n in g.nodes)
    return graph, len(data) / 1e6, count(graph)


def run_graph_timed(graph, feeds, seed: int = EXPORT_SEED) -> tuple:
    import numpy as np

    from xiaoicesing_io_tpu_torch.deployment.onnx_run import run_graph

    t0 = time.perf_counter()
    out = run_graph(graph, feeds, rng=np.random.default_rng(seed))
    return out, time.perf_counter() - t0


def exported(label: str, what, out: Path, name: str, seconds: float) -> tuple:
    graph, mb, nodes = graph_stats(out / f"{name}.onnx")
    log(f"[export {label}] {what}: {seconds:.2f}s; {name}.onnx {mb:.2f} MB, {nodes} nodes "
        f"({len(graph.initializers)} initializers)")
    return graph


def export_vocoder_check(runner, work: Path, name_limit: str) -> dict:
    """The random full-width vocoder of phase 6 exported (the stock f32
    generator), its graph run by the numpy executor on a 256-frame mel and
    f0 of the sample's first segment, against the card's folded vocoder (K2
    twice, K6 27 times) on the same inputs at ``bench/check.py``'s wav bar."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.deployment.export import export_nsf_hifigan
    from xiaoicesing_io_tpu_torch.inference.acoustic import load_ds

    t0 = time.perf_counter()
    out = export_nsf_hifigan(runner.cfg, out_dir=str(work / "nsf_hifigan"))
    graph = exported("vocoder", "export nsf-hifigan", out, "nsf_hifigan",
                     time.perf_counter() - t0)
    batch = runner.preprocess_input(load_ds(ROOT / SAMPLE)[0])
    frames = graph.inputs[0][2][1]
    check.require(batch["f0"].shape[1] >= frames, "the first segment is shorter than the graph")
    mel = runner.forward_model(batch, seed=0)[:, :frames]
    f0 = np.asarray(batch["f0"], np.float32)[:, :frames]
    if runner.cfg.get("mel_base", 10) != "e":
        mel = mel * 2.30259  # the graph takes ln mel, as the vocoder converts it
    feeds = {"in0": mel.astype(np.float32), "in1": f0}
    got, host_s = run_graph_timed(graph, feeds)
    check.zero_launch_counts()
    with torch.no_grad():
        card = runner.vocoder.spec2wav_torch(torch.as_tensor(mel, device="cuda"),
                                             torch.as_tensor(f0, device="cuda"))
    torch.cuda.synchronize()
    launches = check.launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update(check.vocoder_calls(runner.vocoder))
    check.check_launches(launches, want, True, "the card vocoder of the export check")
    res = check.compare_wav(card.cpu().numpy(), got["out0"])
    log(f"[export vocoder] card={name_limit} nsf_hifigan.onnx on the numpy executor: "
        f"{frames} frames in {host_s:.2f}s host; against the card's folded bf16 vocoder "
        f"(launches { {k: v for k, v in want.items() if v} }): wav max_abs_err={res['wav_max_abs_err']:.6g} "
        f"corr={res['wav_corr']:.8f} (tolerance: corr > {check.WAV_TOL_CORR})")
    check.require(res["wav_ok"], f"the exported vocoder disagrees with the card's: {res}")
    return launches


def export_acoustic_check(runner, work: Path, name_limit: str) -> dict:
    """Phase 6's full-width LYNXNet experiment exported; the merged
    ``acoustic.onnx`` run by the numpy executor at the shipped depth and
    :data:`EXPORT_STEPS` Euler steps on the sample's first segment (cut to
    the graph's 64 tokens and 512 frames), against the card's kernel path
    (K1 once per layer per step) from the executor's start noise, at
    ``bench/check.py``'s mel bars."""
    import numpy as np

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.deployment.export import export_acoustic
    from xiaoicesing_io_tpu_torch.inference.acoustic import load_ds

    cfg = runner.cfg
    t0 = time.perf_counter()
    out = export_acoustic(cfg, out_dir=str(work / "acoustic"))
    seconds = time.perf_counter() - t0
    for name in ("fs2_aux", "diffusion_step"):
        exported("acoustic", "export acoustic (with the merged graph)", out, name, seconds)
    graph = exported("acoustic", "export acoustic (with the merged graph)", out, "acoustic",
                     seconds)
    shapes = {n: s for n, _, s in graph.inputs}
    T_ph, T_f = shapes["tokens"][1], shapes["mel2ph"][1]
    batch = runner.preprocess_input(load_ds(ROOT / SAMPLE)[0])
    mel2ph = np.asarray(batch["mel2ph"])[:, :T_f]
    check.require(mel2ph.shape[1] == T_f and mel2ph.max() <= T_ph,
                  "the first segment does not fill the graph's frames within its tokens")
    batch = {"tokens": np.asarray(batch["tokens"], np.int32)[:, :T_ph],
             "mel2ph": mel2ph.astype(np.int32),
             "f0": np.asarray(batch["f0"], np.float32)[:, :T_f]}
    batch["tokens"] = np.pad(batch["tokens"], [(0, 0), (0, T_ph - batch["tokens"].shape[1])])
    t_start = cfg.get("T_start_infer", runner.core.t_start)
    feeds = dict(batch, depth=np.asarray(1.0 - t_start, np.float32),
                 steps=np.asarray(EXPORT_STEPS, np.int64))
    got, host_s = run_graph_timed(graph, feeds)
    noise = np.random.default_rng(EXPORT_SEED).standard_normal(
        (1, 1, T_f, cfg["audio_num_mel_bins"])).astype(np.float32)
    steps = cfg["sampling_steps"]
    cfg["sampling_steps"] = EXPORT_STEPS
    try:
        check.zero_launch_counts()
        card = runner.forward_model(batch, noise=noise)
        launches = check.launch_counts()
    finally:
        cfg["sampling_steps"] = steps
    want = dict.fromkeys(launches, 0)
    want["lynx_conv_module"] = len(runner.model.backbone.residual_layers) * EXPORT_STEPS
    check.check_launches(launches, want, True, "the card sampler of the export check")
    res = check.compare_mel(card, got["mel"])
    log(f"[export acoustic] card={name_limit} acoustic.onnx on the numpy executor: depth "
        f"{1.0 - t_start:.2f}, {EXPORT_STEPS} steps, {T_ph} tokens x {T_f} frames in "
        f"{host_s:.2f}s host; against the card's K1 path from the same noise (launches "
        f"{ {k: v for k, v in want.items() if v} }): mel max_abs_err={res['mel_max_abs_err']:.6g} "
        f"max_abs_ref={res['mel_max_abs_ref']:.6g} (rel {res['mel_rel_err']:.6g}) "
        f"corr={res['mel_corr']:.8f} (tolerance: {check.tolerance_text()})")
    check.require(res["mel_ok"], f"the exported acoustic graph disagrees with the card's: {res}")
    return launches


def export_variance_check(variance_cfg, work: Path, name_limit: str) -> dict:
    """Phase 7b's full-width variance experiment exported; the merged
    ``pitch.onnx`` run by the numpy executor at the shipped steps on inputs
    drawn from :data:`EXPORT_SEED`, against the card's pitch head (K4 once per
    layer per step) from the executor's start noise, at phase 7b's bar
    (:data:`PITCH_TOL_CENTS` RMS, corr > :data:`PITCH_MIN_CORR`)."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.deployment.export import export_variance
    from xiaoicesing_io_tpu_torch.inference.variance import DiffSingerVarianceInfer, head_denoiser

    t0 = time.perf_counter()
    out = export_variance(variance_cfg, out_dir=str(work / "variance"))
    seconds = time.perf_counter() - t0
    for name in ("linguistic_dur", "frame_condition", "pitch_pre", "pitch_step",
                 "variance_pre", "variance_step", "variance"):
        exported("variance", "export variance (with the merged graphs)", out, name, seconds)
    graph = exported("variance", "export variance (with the merged graphs)", out, "pitch",
                     seconds)
    runner = DiffSingerVarianceInfer(variance_cfg, device="cuda")
    shapes = {n: s for n, _, s in graph.inputs}
    T_f, T_n = shapes["mel2ph"][1], shapes["note_midi"][1]
    T_ph = 64
    H = variance_cfg["hidden_size"]
    rng = np.random.default_rng(EXPORT_SEED)
    notes = np.sort(rng.integers(1, T_n + 1, (1, T_f)), axis=1)
    values = {
        "condition": rng.standard_normal((1, T_f, H)).astype(np.float32),
        "mel2ph": np.sort(rng.integers(1, T_ph + 1, (1, T_f)), axis=1).astype(np.int32),
        "base_pitch": (60.0 + rng.uniform(-5, 5, (1, T_n)))[0][notes - 1].astype(np.float32),
        "pitch_expr": rng.uniform(0.5, 1.0, (1, T_f)).astype(np.float32),
        "note_midi": rng.uniform(55, 70, (1, T_n)).astype(np.float32),
        "note_rest": rng.uniform(size=(1, T_n)) < 0.1,
        "note_dur": np.bincount(notes[0] - 1, minlength=T_n)[None].astype(np.int32),
        "note_glide": rng.integers(0, 3, (1, T_n)).astype(np.int32),
        "mel2note": notes.astype(np.int32),
    }
    steps = variance_cfg.get("sampling_steps", 20)
    feeds = dict(values, depth=np.asarray(1.0, np.float32), steps=np.asarray(steps, np.int64))
    feeds = {n: feeds[n] for n in shapes}
    got, host_s = run_graph_timed(graph, feeds)
    shape = tuple(graph_stats(out / "pitch_step.onnx")[0].inputs[0][2])  # the pitch head's x
    noise = np.random.default_rng(EXPORT_SEED).standard_normal(shape).astype(np.float32)
    t = {k: torch.as_tensor(v, device="cuda") for k, v in values.items()}
    with torch.no_grad():
        cond = runner.model.pitch_condition(
            t["condition"], t["mel2ph"].long(), t["base_pitch"], pitch_expr=t["pitch_expr"],
            note_midi=t["note_midi"], note_rest=t["note_rest"], note_dur=t["note_dur"].long(),
            note_glide=t["note_glide"].long(), mel2note=t["mel2note"].long())
        den = head_denoiser(runner.heads()["pitch"], cond, runner.kernel_weights["pitch"],
                            runner.compute_dtype)
        check.zero_launch_counts()
        x = runner.core.inference(den, shape, t_start=0.0, steps=steps, algorithm="euler",
                                  noise=torch.as_tensor(noise, device="cuda"))
        card = runner.normalizers["pitch"].denorm(x).cpu().numpy()
    launches = check.launch_counts()
    want = dict.fromkeys(launches, 0)
    want["wavenet_block"] = len(runner.heads()["pitch"].residual_layers) * steps
    check.check_launches(launches, want, True, "the card pitch head of the export check")
    cents = 100.0 * (got["pitd"] - card)
    rms = float(np.sqrt(np.mean(cents ** 2)))
    corr = float(np.corrcoef(got["pitd"].ravel(), card.ravel())[0, 1])
    log(f"[export variance] card={name_limit} pitch.onnx on the numpy executor: {steps} steps, "
        f"{T_f} frames in {host_s:.2f}s host; against the card's pitch head on K4 from the same "
        f"noise (launches { {k: v for k, v in want.items() if v} }): max_abs_err="
        f"{np.abs(cents).max():.4f} cents rms={rms:.4f} cents corr={corr:.8f} (tolerance rms <= "
        f"{PITCH_TOL_CENTS}, corr > {PITCH_MIN_CORR})")
    check.require(rms <= PITCH_TOL_CENTS and corr > PITCH_MIN_CORR,
                  "the exported pitch graph disagrees with the card's pitch head")
    del runner
    torch.cuda.empty_cache()
    return launches


def run_export(lynx_runner, variance_cfg, work: Path, name_limit: str) -> dict:
    """Phase 16: the exporters on the CPU, their graphs on the numpy
    executor, held against the card: the vocoder against K2 and K6, the
    merged acoustic graph against K1, the merged pitch graph against K4.
    Returns the card's launches in those checks, summed."""
    t_phase = time.perf_counter()
    vocoder = export_vocoder_check(lynx_runner, work, name_limit)
    acoustic = export_acoustic_check(lynx_runner, work, name_limit)
    pitch = export_variance_check(variance_cfg, work, name_limit)
    log(f"[done 16] {time.perf_counter() - t_phase:.1f}s")
    return {k: vocoder[k] + acoustic[k] + pitch[k] for k in vocoder}


BENCH_KEEP = ('{"metric"', "[check", "[trace", "[cell", "[setup", "[metric")


# ---------------------------------------------------------------------------
# phase 18: several cards. Data-parallel training (two gloo ranks sharing the
# card; NCCL at one rank, and across cards where there are several) and
# serving over several devices (K1 / K4 on every replica, K2 and K6 after)
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_FRAMES = 12000            # (a): each rank's frame budget (max_batch_frames)
DP_ROWS = 16                 # (a): max_batch_size
DP_GRAD_TOL = 1e-3           # (a): gradients against one process's, of each tensor's scale
DP_FIT_STEPS, DP_FIT_VAL_EVERY = 4, 2   # (b)


def _dp_spawn(fn, world: int, work: Path, *args, timeout: float = 600.0) -> list:
    """``fn(rank, world, work, *args)`` in ``world`` spawned processes;
    their results (``torch.save``) in rank order.  A process that raises
    writes its traceback, which is raised here; every process is joined (or
    killed at the time limit) before this returns."""
    import multiprocessing as mp

    import torch

    work.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dp_entry, args=(fn, r, world, str(work), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = [(work / f"error_{r}.txt").read_text() for r in range(world)
              if (work / f"error_{r}.txt").exists()]
    if errors or alive or any(p.exitcode for p in procs):
        raise RuntimeError(f"{fn.__name__}: exit codes {[p.exitcode for p in procs]}, "
                           f"{len(alive)} killed at {timeout:.0f} s\n" + "\n".join(errors))
    return [torch.load(work / f"result_{r}.pt", weights_only=False) for r in range(world)]


def _dp_entry(fn, rank: int, world: int, work: str, args) -> None:
    import traceback

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = fn(rank, world, Path(work), *args)
        torch.save(out, Path(work) / f"result_{rank}.pt")
    except BaseException:
        (Path(work) / f"error_{rank}.txt").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dp_cfgs(lynx_cfg, train: Path, work: Path, frames: int) -> dict:
    """(a)'s configurations: phase 13's shipped acoustic (LYNXNet 1024 x 6)
    and variance (energy, breathiness) ones on phase 13's sets, in f32,
    dropout 0 (the ranks' dropout streams differ from one process's), a
    frame budget of ``frames`` a rank."""
    from xiaoicesing_io_tpu_torch.config import Config, variance_defaults

    acoustic = Config(lynx_cfg, binary_data_dir=str(train / "acoustic_binary"),
                      work_dir=str(work / "acoustic_exp"), precision="fp32", dropout=0.0,
                      max_batch_frames=frames, max_batch_size=DP_ROWS)
    acoustic["shallow_diffusion_args"]["aux_decoder_args"]["dropout_rate"] = 0.0
    variance = variance_defaults()
    variance.update(dictionary=lynx_cfg["dictionary"],
                    binary_data_dir=str(train / "variance_binary"),
                    work_dir=str(work / "variance_exp"), predict_energy=True,
                    predict_breathiness=True, precision="fp32", dropout=0.0,
                    max_batch_frames=frames, max_batch_size=DP_ROWS)
    variance["dur_prediction_args"]["dropout"] = 0.0
    return {"acoustic": acoustic, "variance": variance}


def _flat(tensors) -> "torch.Tensor":
    import torch

    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _dp_updates(trainer, generator, batches, shard=None):
    """Two updates of ``trainer``'s step on ``batches`` (numpy; one for
    each update); returns (the first update's gradients as the clip received
    them, ms of each update on the card's timeline)."""
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.training import train_state as ts
    from xiaoicesing_io_tpu_torch.training.trainer import widen_batch

    seen, ms = [], []
    clip = ts.clip_by_global_norm

    def recorded(grads, max_norm):
        seen.append([g.detach().clone() for g in grads])
        return clip(grads, max_norm)

    ts.clip_by_global_norm = recorded
    try:
        for batch in batches:
            tensors = widen_batch(trainer._to_device(batch))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            kw = {"shard": shard} if shard else {}
            updated, _ = trainer.train_step(trainer.state, tensors, generator, **kw)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            check.require(updated, "an update did not happen")
    finally:
        ts.clip_by_global_norm = clip
    return seen[0], ms


def _dp_train_rank(rank: int, world: int, work: Path, backend: str, cfgs: dict,
                   devices: list) -> dict:
    """(a) on one rank: for each configuration, the trainer of a group of
    ``world`` ranks (``backend``, this rank on ``devices[rank]``) takes two
    updates on its sampler batches (restored and broadcast from rank 0 as
    ``fit`` does, the draws the global batch's); rank 0 holds its
    parameters and gradients against every other rank's, bit for bit, and
    the other ranks save their batches.  Then, out of the group, rank 0
    takes the same two updates in one process on the ranks' batches
    concatenated in rank order, from the same seed: the first update's
    gradients against the ranks'.  Every kernel must launch 0 times."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.parallel import mesh
    from xiaoicesing_io_tpu_torch.training.tasks import (
        build_acoustic_trainer, build_variance_trainer,
    )

    build = {"acoustic": build_acoustic_trainer, "variance": build_variance_trainer}
    device = torch.device(devices[rank])
    mesh.init_distributed(num_processes=world, process_id=rank, backend=backend, device=device,
                          init_method=f"file://{work}/rendezvous_{backend}")
    out, kept = {}, {}
    check.zero_launch_counts()
    for leg, cfg in cfgs.items():
        trainer = build[leg](cfg, device=device, writer=None)
        trainer._restore()
        sampler = trainer._make_sampler(0)
        batches = [trainer._collate_train(sampler.batches[i],
                                          trainer._global_shape_targets(sampler, i))
                   for i in range(2)]
        generator = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 0)))
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        grads, ms = _dp_updates(trainer, generator, batches, shard=(rank, world))
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        params, flat_g = _flat(trainer.state.params), _flat(grads)
        equal = [True, True]
        for src in range(1, world):
            for i, mine in enumerate((params, flat_g)):
                theirs = mine.clone()
                dist.broadcast(theirs, src)
                equal[i] = equal[i] and bool(torch.equal(mine, theirs))
                del theirs
        if rank > 0:
            torch.save(batches, work / f"batches_{leg}_{rank}.pt")
        mesh.barrier()
        out[leg] = {"ms": ms, "peak_gib": peak, "params_equal": equal[0],
                    "grads_equal": equal[1],
                    "rows": [int(b["mel2ph"].shape[0]) for b in batches],
                    "frames": [int(b["mel2ph"].shape[1]) for b in batches],
                    "real_frames": [int((b["mel2ph"] > 0).sum()) for b in batches],
                    "n_params": int(params.numel())}
        if rank == 0:
            kept[leg] = ([g.cpu() for g in grads], params.cpu(), batches)
        del trainer, grads, params, flat_g
        torch.cuda.empty_cache()
    out["launches"] = check.launch_counts()
    dist.destroy_process_group()
    if rank == 0:  # one process on the concatenated batches
        for leg, cfg in cfgs.items():
            grads, params, batches = kept.pop(leg)
            every = [batches] + [torch.load(work / f"batches_{leg}_{r}.pt", weights_only=False)
                                 for r in range(1, world)]
            whole = [{k: np.concatenate([b[i][k] for b in every]) for k in batches[i]}
                     for i in range(len(batches))]
            trainer = build[leg](cfg, device=device, writer=None)
            generator = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 0)))
            torch.cuda.reset_peak_memory_stats(device)
            ref, ms = _dp_updates(trainer, generator, whole)
            worst, worst_name = 0.0, None
            names = [n for n, p in trainer.state.model.named_parameters() if p.requires_grad]
            for name, g, r in zip(names, grads, ref):
                r = r.float().cpu()
                err = float((g.float() - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                if err > worst:
                    worst, worst_name = err, name
            p_ref = _flat(trainer.state.params).cpu()
            out[leg].update(grad_worst=worst, grad_worst_name=worst_name,
                            params_worst=float((params - p_ref).abs().max())
                            / float(p_ref.abs().max()),
                            one_process_ms=ms,
                            one_process_peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
            del trainer, ref
            torch.cuda.empty_cache()
    return out


def _dp_fit_process(rank: int, world: int, work: Path, cfg) -> dict:
    """(b): ``Trainer.fit`` in a process of its own with deterministic
    algorithms, process 0 in an NCCL group of one rank (its all-reduce,
    broadcast and barrier run first), process 1 in no group, each in a work
    dir of its own; its launches and a digest of every parameter."""
    import hashlib
    import os

    import torch
    import torch.distributed as dist

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.config import Config
    from xiaoicesing_io_tpu_torch.training.tasks import build_acoustic_trainer

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    group = "nccl" if rank == 0 else "none"
    out = {"group": group}
    if group == "nccl":
        dist.init_process_group("nccl", init_method=f"file://{work}/rendezvous_nccl1",
                                world_size=1, rank=0, device_id=device)
        t = torch.arange(8.0, device=device)
        dist.all_reduce(t)
        dist.broadcast(t, 0)
        dist.barrier()
        check.require(torch.equal(t, torch.arange(8.0, device=device)),
                      "NCCL at one rank changed a tensor")
        out["backend"] = dist.get_backend()
    torch.manual_seed(0)
    trainer = build_acoustic_trainer(Config(cfg, work_dir=str(work / f"exp_{group}")),
                                     device=device, writer=Recorder())
    check.zero_launch_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    out.update(seconds=time.perf_counter() - t0, launches=check.launch_counts(),
               step=trainer.state.step, audio=len(trainer.writer.audio),
               digest={n: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
                       for n, p in trainer.state.model.named_parameters()})
    return out


def run_dp_training(lynx_cfg, train: Path, work: Path, name_limit: str, per_call: dict) -> dict:
    """Phase 18 (a) and (b), on phase 13's sets.  (a) Two ranks on the one
    card under ``gloo``, each with its own sampler batches of the shipped
    acoustic and variance configurations (f32, TF32 off), two updates: the
    ranks' parameters bit for bit equal, their first update's gradients
    within ``DP_GRAD_TOL`` of each tensor's scale of one process's on the
    concatenated batches; each process's ms per update and peak memory.
    Where there are two or more cards, the same under NCCL, one card a rank.
    (b) ``Trainer.fit`` of the shipped acoustic configuration
    (``DP_FIT_STEPS`` updates, validating every ``DP_FIT_VAL_EVERY`` with
    ``TRAIN_PLOTS`` plots) in an NCCL group of one rank against the same fit
    in no group: every parameter bit for bit, the extras' launches exactly
    phase 13's prediction for that run.  Returns (b)'s launches."""
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.config import Config

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    runs = [("gloo", ["cuda:0"] * DP_RANKS)]
    if cards >= 2:
        runs.append(("nccl", [f"cuda:{r}" for r in range(cards)]))
    else:
        log(f"[dp train nccl] not run: {cards} card; NCCL takes one card a rank (two ranks on "
            f"one card: 'Duplicate GPU detected')")
    for backend, devices in runs:
        # the global batch stays at DP_RANKS x DP_FRAMES frames, so every rank takes two steps
        cfgs = _dp_cfgs(lynx_cfg, train, work / backend, DP_FRAMES * DP_RANKS // len(devices))
        t0 = time.perf_counter()
        ranks = _dp_spawn(_dp_train_rank, len(devices), work / f"ranks_{backend}", backend,
                          cfgs, devices)
        seconds = time.perf_counter() - t0
        for r in ranks:
            check.require(not any(r["launches"].values()),
                          f"a train step launched a kernel: {r['launches']}")
        for leg in cfgs:
            r0 = ranks[0][leg]
            per_rank = "; ".join(
                f"rank {i}: real frames {r[leg]['real_frames']}, ms per update "
                f"{' '.join(f'{m:.2f}' for m in r[leg]['ms'])}, peak_mem_gib "
                f"{r[leg]['peak_gib']:.3f}" for i, r in enumerate(ranks))
            log(f"[dp train {backend} {leg}] card={name_limit} {len(devices)} ranks on "
                f"{devices}, f32 TF32 off, {r0['n_params']} parameters; batches a rank: rows "
                f"{r0['rows']}, frames {r0['frames']}; {per_rank}; one process on the ranks' "
                f"batches: ms {' '.join(f'{m:.2f}' for m in r0['one_process_ms'])}, "
                f"peak_mem_gib {r0['one_process_peak_gib']:.3f}; parameters bit for bit equal "
                f"across ranks {r0['params_equal']}, gradients {r0['grads_equal']}; first "
                f"update's gradients against one process: worst {r0['grad_worst']:.3g} of "
                f"its scale ({r0['grad_worst_name']}; tolerance {DP_GRAD_TOL}); parameters "
                f"after two updates {r0['params_worst']:.3g} of their scale")
            check.require(r0["params_equal"] and r0["grads_equal"],
                          f"{backend} {leg}: the ranks' parameters or gradients differ")
            check.require(r0["grad_worst"] <= DP_GRAD_TOL,
                          f"{backend} {leg}: the ranks' gradients disagree with one process's")
        log(f"[dp train {backend}] {seconds:.1f}s for both configurations (process start "
            f"included)")

    cfg = Config(lynx_cfg, binary_data_dir=str(train / "acoustic_binary"),
                 max_updates=DP_FIT_STEPS, val_check_interval=DP_FIT_VAL_EVERY,
                 num_valid_plots=TRAIN_PLOTS, log_interval=DP_FIT_VAL_EVERY,
                 max_batch_frames=DP_FRAMES)
    t0 = time.perf_counter()
    fits = {f["group"]: f for f in _dp_spawn(_dp_fit_process, 2, work / "fit", cfg)}
    seconds = time.perf_counter() - t0
    layers, steps = cfg["backbone_args"]["num_layers"], cfg["sampling_steps"]
    n_val = DP_FIT_STEPS // DP_FIT_VAL_EVERY
    expect = {name: 0 for name, _, _ in check.counters()}
    expect["lynx_conv_module"] = n_val * TRAIN_PLOTS * steps * layers
    expect.update({k: v * (n_val * TRAIN_PLOTS + TRAIN_PLOTS) for k, v in per_call.items()})
    nccl, alone = fits["nccl"], fits["none"]
    same = [n for n in alone["digest"] if nccl["digest"][n] == alone["digest"][n]]
    log(f"[dp train fit] card={name_limit} Trainer.fit of the shipped acoustic configuration "
        f"({DP_FIT_STEPS} updates, validations every {DP_FIT_VAL_EVERY}, {TRAIN_PLOTS} plots, "
        f"deterministic algorithms) in an NCCL group of one rank ({nccl.get('backend')}) and in "
        f"no group, side by side on the card: steps {nccl['step']} / {alone['step']}; fit seconds "
        f"{nccl['seconds']:.2f} / {alone['seconds']:.2f} ({seconds:.1f}s with the processes' "
        f"start); parameters bit "
        f"for bit equal: {len(same)} of {len(alone['digest'])} tensors; launches "
        f"{nccl['launches']} / {alone['launches']}; expected "
        f"{ {k: v for k, v in expect.items() if v} }, every other kernel 0")
    check.check_launches(nccl["launches"], expect, True, "the fit in an NCCL group of one rank")
    check.check_launches(alone["launches"], expect, True, "the fit in no group")
    check.require(len(same) == len(alone["digest"]) and nccl["step"] == DP_FIT_STEPS,
                  "the fit in an NCCL group of one rank differs from the fit in no group")
    log(f"[done 18ab] {time.perf_counter() - t_phase:.1f}s")
    return nccl["launches"]


def run_dp_only(name_limit: str) -> None:
    """Phase 18 alone (``--dp-only``): the experiments of phases 6 and 7
    and phase 13's sets made afresh, then (c), (a) and (b)."""
    import torch

    from xiaoicesing_io_tpu_torch.bench import cells, check

    work = ROOT / ".work" / "chip_smoke_dp"
    shutil.rmtree(work, ignore_errors=True)
    try:
        lynx, _ = cells.open_cell("lynx_reflow_b4_t2048", work / "lynx", device="cuda")
        wavenet, _ = cells.open_cell("wavenet_ddpm_b4_t2048", work / "wavenet", device="cuda")
        run_dp_serving(lynx, wavenet, work / "dp_serve", name_limit)
        cfg, per_call = lynx.cfg, check.vocoder_calls(lynx.vocoder)
        del lynx, wavenet
        torch.cuda.empty_cache()
        vocab = _vocab(cfg)
        _write_sets(work / "train" / "acoustic_binary", acoustic_train_items, vocab)
        _write_sets(work / "train" / "variance_binary", variance_train_items, vocab)
        run_dp_training(cfg, work / "train", work / "dp_train", name_limit, per_call)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_dp_serving(lynx_runner, wavenet_runner, work: Path, name_limit: str) -> dict:
    """Phase 18 (c), on the experiments of phases 6 and 7 after phase 15:
    the sample ``.ds`` through ``run_inference(data_parallel=True)`` with
    ``devices`` every visible card, then ``[cuda:0, cuda:0]``, the launch
    counters zeroed just before each run and read just after: K1 (LYNXNet)
    or K4 (WaveNet) exactly ``n_dev`` x phase 15's count, K2 and K6 phase
    15's, nothing else; every segment's mel within ``bench/check.py``'s
    bars of the one-device run at the same seed (phase 15's), the largest
    difference printed.  Then ``SERVE_TIMING`` on the LYNXNet experiment
    with one and two replicas (audio-s/s; not a speed claim).  Returns the
    launches, summed."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.bench import check
    from xiaoicesing_io_tpu_torch.bench.cells import _silent
    from xiaoicesing_io_tpu_torch.inference.acoustic import load_ds
    from xiaoicesing_io_tpu_torch.inference.serving import DataParallelSynthesizer, plan_chunks

    t_phase = time.perf_counter()
    every = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    shared = [torch.device("cuda", 0)] * 2
    total = {name: 0 for name, _, _ in check.counters()}
    params = load_ds(ROOT / SAMPLE)
    for label, runner in (("lynx_reflow", lynx_runner), ("wavenet_ddpm", wavenet_runner)):
        batches = [_silent(runner.preprocess_input, p) for p in params]
        lengths = [b["mel2ph"].shape[1] for b in batches]
        one, _ = _silent(DataParallelSynthesizer(runner, [runner.device]).synthesize_mels,
                         params, seed=0, batches=batches)
        for devices in (every, shared):
            n_dev = len(devices)
            plan = plan_chunks(lengths, None, n_dev)
            want = check.implied_launches(runner, len(plan), len(set(lengths)))
            denoiser = "wavenet_block" if runner.backbone_type == "wavenet" else "lynx_conv_module"
            want[denoiser] *= n_dev
            hooks, rec = record_serving()
            torch.cuda.synchronize()
            check.zero_launch_counts()
            t0 = time.perf_counter()
            with hooks:
                _silent(runner.run_inference, params, out_dir=work / label, title="dp", seed=0,
                        data_parallel=True, devices=devices)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = check.launch_counts()
            check.check_launches(launches, want, True, f"the {label} run on {devices}")
            for k, v in launches.items():
                total[k] += v
            mels = rec["mels"][1][0]
            wavs = rec["wavs"][1]
            worst = {"mel_rel_err": 0.0, "mel_corr": 1.0, "max_abs": 0.0}
            for i, (m, ref) in enumerate(zip(mels, one, strict=True)):
                got = check.compare_mel(m, ref)
                check.require(got["mel_ok"], f"{label} on {devices}: segment {i}: {got}")
                worst["mel_rel_err"] = max(worst["mel_rel_err"], got["mel_rel_err"])
                worst["mel_corr"] = min(worst["mel_corr"], got["mel_corr"])
                worst["max_abs"] = max(worst["max_abs"], float(np.abs(m - ref).max()))
            check.require(all(np.isfinite(w).all() for w in wavs), f"{label}: a wav is not finite")
            log(f"[dp serve {label}] card={name_limit} devices {[str(d) for d in devices]}: "
                f"{len(plan)} chunks of {[len(i) for _, _, i in plan]} rows, padded to "
                f"{n_dev}; launches {launches}, expected "
                f"{ {k: v for k, v in want.items() if v} } ({denoiser} {n_dev} x phase 15's), "
                f"every other kernel 0; every segment against the one-device run, seed 0: "
                f"worst mel rel err {worst['mel_rel_err']:.6g}, corr {worst['mel_corr']:.8f}, "
                f"largest difference {worst['max_abs']:.6g} (tolerance: "
                f"{check.tolerance_text()}); {seconds:.3f}s")
    timing = load_ds(ROOT / SERVE_TIMING)
    audio = sum(_silent(lynx_runner.preprocess_input, p)["mel2ph"].shape[1] for p in timing) \
        * lynx_runner.cfg["hop_size"] / lynx_runner.cfg["audio_sample_rate"]
    rates = {1: [], 2: []}
    for n in (2, 1, 2, 2, 1):  # a warm-up of two replicas, then in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _silent(lynx_runner.run_inference, timing, out_dir=work / "timing", title="timing",
                seed=0, data_parallel=True, devices=shared[:n])
        torch.cuda.synchronize()
        rates[n].append(audio / (time.perf_counter() - t0))
    log(f"[dp serve timing] card={name_limit} {SERVE_TIMING} ({audio:.2f} s of audio) through "
        f"run_inference(data_parallel=True) on cuda:0 with one replica: audio_s_per_s "
        f"{' '.join(f'{r:.4f}' for r in rates[1])}; with [cuda:0, cuda:0]: "
        f"{' '.join(f'{r:.4f}' for r in rates[2][1:])} (warm-up {rates[2][0]:.4f}); both "
        f"slices run on the one card, so this is no speed claim")
    log(f"[done 18c] {time.perf_counter() - t_phase:.1f}s")
    return total


def check_seq_ops(name_limit: str) -> None:
    """Phase 19: the three alignment ops of ``ops/seq.py`` on ``cuda:0``
    against the CPU at the sample ``.ds``'s sizes."""
    import numpy as np
    import torch

    from xiaoicesing_io_tpu_torch.config import acoustic_defaults
    from xiaoicesing_io_tpu_torch.inference.acoustic import load_ds
    from xiaoicesing_io_tpu_torch.ops import seq

    t0 = time.perf_counter()
    cfg = acoustic_defaults()
    timestep = cfg.hop_size / cfg.audio_sample_rate
    rows = []
    for seg in load_ds(ROOT / SAMPLE):
        ph_dur = np.array(seg["ph_dur"].split(), np.float32)
        ph_acc = np.round(np.cumsum(ph_dur) / timestep + 0.5).astype(np.int64)
        rows.append(np.diff(ph_acc, prepend=0))
    dur = np.zeros((len(rows), max(map(len, rows))), np.int64)
    for i, row in enumerate(rows):
        dur[i, :len(row)] = row
    B, t_txt = dur.shape
    frames = int(dur.sum(1).max())
    card_dev = torch.device("cuda:0")

    def both(fn, *args, **kw):
        """``fn`` on the CPU and on the card (its arrays as tensors there);
        the card's output on the CPU."""
        def on(device):
            return [torch.from_numpy(a).to(device) if isinstance(a, np.ndarray) else a
                    for a in args]

        ref = fn(*on("cpu"), **kw)
        got = fn(*on(card_dev), **kw)
        if got.device != card_dev or got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"[seq ops] {fn.__name__}{kw}: the card gave {got.dtype} "
                                 f"{tuple(got.shape)} on {got.device}, the CPU {ref.dtype} "
                                 f"{tuple(ref.shape)}")
        return got.cpu(), ref

    def equal(what, got, ref):
        if not torch.equal(got, ref):
            n = int((got != ref).sum())
            raise AssertionError(f"[seq ops] {what}: {n} elements differ from the CPU's")

    mel2ph = None
    for alpha in (None, 0.5, 1.5):
        out_len = frames if alpha is None else int(round(frames * alpha)) + 8
        got, ref = both(seq.length_regulator, dur, out_len, alpha=alpha)
        equal(f"length_regulator(alpha={alpha})", got, ref)
        if alpha is None:
            mel2ph = ref.numpy()
    longest = int(dur.max())
    for max_dur in (None, longest - 2):
        got, ref = both(seq.mel2ph_to_dur, mel2ph, t_txt, max_dur=max_dur)
        equal(f"mel2ph_to_dur(max_dur={max_dur})", got, ref)
        if max_dur is None and not np.array_equal(got.numpy(), dur):
            raise AssertionError("[seq ops] mel2ph_to_dur does not give back the durations")
    got, ref = both(seq.stretch_regulator, mel2ph, dur)
    err = float((got - ref).abs().max())
    if not err <= 1e-6:
        raise AssertionError(f"[seq ops] stretch_regulator: max |card - CPU| {err:.3e} > 1e-6")
    torch.cuda.synchronize()
    log(f"[seq ops] {SAMPLE}: B={B} segments, {t_txt} tokens, {frames} frames; "
        f"length_regulator (alpha None, 0.5, 1.5) and mel2ph_to_dur (max_dur None, {longest - 2})"
        f" equal to the CPU's, stretch_regulator max |card - CPU| {err:.3e} (<= 1e-6); "
        f"{name_limit}")
    log(f"[done 19] {time.perf_counter() - t0:.1f}s")


def run_bench() -> None:
    """Phase 11: the bench end to end, ``python -m xiaoicesing_io_tpu_torch.bench
    --runs 1`` (every cell of ``BENCHMARK.json`` and the WaveNet margin line)
    in a process of its own, which reuses the kernels built above.  It must
    exit 0 and end with its headline; its checks, metrics and breakdowns are
    echoed here."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "xiaoicesing_io_tpu_torch.bench", "--runs", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        if line.startswith(BENCH_KEEP) and not line.startswith('{"cell"'):
            log(f"[bench] {line[:400]}")
    if proc.returncode != 0 or not lines or '"audio_seconds_synthesized' not in lines[-1]:
        log(proc.stderr[-4000:])
        raise AssertionError(f"the bench exited {proc.returncode}")
    log(f"[bench] headline {lines[-1]}")
    log(f"[bench] python -m xiaoicesing_io_tpu_torch.bench --runs 1: {seconds:.1f}s wall, exit 0")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "xiaoicesing_io_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    name_limit = card()
    print(name_limit, flush=True)
    log(f"[card] {name_limit} torch={torch.__version__} cuda={torch.version.cuda} "
        f"devices={torch.cuda.device_count()}")

    from xiaoicesing_io_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    seconds = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f}s wall; per source: "
        + ", ".join(f"{k}={v:.1f}s" for k, v in seconds.items()))
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "error" in line.lower():
                log(f"[build:{name}] {line.strip()}")
        for u in build.resource_usage(name):  # one line a kernel, marked where it spills
            spills = "SPILLS " if u["spill_stores"] or u["spill_loads"] else ""
            log(f"[build:{name}] {spills}{u['kernel']}: registers {u['registers']}, stack frame "
                f"{u['stack']} B, spill stores {u['spill_stores']} B, spill loads "
                f"{u['spill_loads']} B")

    if "--dp-only" in argv:
        run_dp_only(name_limit)
        log(f"[done] phase 18 only, {time.perf_counter() - t_start:.1f}s")
        return 0
    k1 = check_k1()
    k2 = check_k2()
    k4 = check_k4()
    k3 = check_k3()
    variants = check_variants()
    k6 = check_k6()
    k2_stage_ms, k6_stage_ms = k2.pop("stage_ms"), k6.pop("stage_ms")
    if "--kernels-only" in argv:
        log(f"[done] kernels only, {time.perf_counter() - t_start:.1f}s")
        return 0
    check_seq_ops(name_limit)

    work = ROOT / ".work" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        lynx, lynx_runner, ds_wav, per_call = run_configuration(
            "lynx_reflow", "lynx_reflow_b4_t2048", work / "lynx", name_limit,
            {"K1": k1, "K2": k2, "K6": k6})
        wavenet, wavenet_runner, _, _ = run_configuration(
            "wavenet_ddpm", "wavenet_ddpm_b4_t2048", work / "wavenet", name_limit,
            {"K4": k4, "K2": k2, "K6": k6})
        serving = run_serving(lynx_runner, wavenet_runner, work / "serve", name_limit)
        dp_serving = run_dp_serving(lynx_runner, wavenet_runner, work / "dp_serve", name_limit)
        lynx_cfg = lynx_runner.cfg
        del wavenet_runner
        torch.cuda.empty_cache()
        variance, variance_cfg = run_variance_pipeline(work / "pipeline", name_limit)
        export = run_export(lynx_runner, variance_cfg, work / "export", name_limit)
        del lynx_runner
        torch.cuda.empty_cache()
        copysyn = run_copy_synthesis(lynx_cfg, ds_wav, work / "copysyn", name_limit, per_call)
        evaluation = run_evaluation(lynx_cfg, variance_cfg, work / "eval", name_limit, per_call)
        training = run_training(lynx_cfg, work / "train", name_limit, per_call)
        bridge = run_bridge(work / "train", work / "bridge", name_limit)
        dp_training = run_dp_training(lynx_cfg, work / "train", work / "dp_train", name_limit,
                                      per_call)
        binarization = run_binarization(lynx_cfg, work / "binarize", name_limit)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sweep = run_sampler_sweep(name_limit)
    run_vocoder_sweep(name_limit, k2_stage_ms, k6_stage_ms)
    run_bench()

    kernels = [
        dict(name="lynx_conv_module", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/lynx_conv.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/lynx_conv.py:116",
             launches=lynx["lynx_conv_module"],
             eval_path_launches=evaluation["lynx_conv_module"],
             training_path_launches=training["lynx_conv_module"],
             bridge_check_launches=bridge["lynx_conv_module"], library_ms=None, **k1),
        dict(name="fused_resblock_stage", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/hifigan_stage.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/hifigan_stage.py:120",
             launches=lynx["fused_resblock_stage"],
             eval_path_launches=evaluation["fused_resblock_stage"],
             training_path_launches=training["fused_resblock_stage"],
             bridge_check_launches=bridge["fused_resblock_stage"], library_ms=None, **k2),
        dict(name="wavenet_block", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/wavenet_block.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/wavenet_block.py:75",
             launches=wavenet["wavenet_block"],
             variance_path_launches=variance["wavenet_block"],
             eval_path_launches=evaluation["wavenet_block"],
             training_path_launches=training["wavenet_block"],
             bridge_check_launches=bridge["wavenet_block"], library_ms=None, **k4),
        dict(name="mel_spectrogram", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/mel_spec.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/mel_kernel.py:100",
             launches=copysyn["mel_spectrogram"], **k3),
        dict(name="lynx_layer_fused", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/lynx_layer.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/lynx_conv2.py:132",
             launches=sweep["lynx_layer_fused"], library_ms=None, **variants["K5"]),
        dict(name="lynx_layer_fused_v3", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/lynx_layer.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/lynx_conv3.py:113",
             launches=sweep["lynx_layer_fused_v3"], library_ms=None, **variants["K7"]),
        dict(name="lynx_conv_tail", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/lynx_hybrid.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/lynx_hybrid.py:58",
             launches=sweep["lynx_conv_tail"], library_ms=None, **variants["K8"]),
        dict(name="resblock_unit", route="cuda",
             source="xiaoicesing_io_tpu_torch/csrc/hifigan_resblock.cu",
             replaces="xiaoicesing_io_tpu/ops/pallas/hifigan_resblock.py:105",
             launches=lynx["resblock_unit"],
             eval_path_launches=evaluation["resblock_unit"],
             training_path_launches=training["resblock_unit"],
             bridge_check_launches=bridge["resblock_unit"], library_ms=None, **k6),
    ]
    for entry in kernels:
        entry["binarize_path_launches"] = binarization[entry["name"]]
        entry["serve_path_launches"] = serving[entry["name"]]
        entry["export_check_launches"] = export[entry["name"]]
        entry["dp_serve_launches"] = dp_serving[entry["name"]]
        entry["dp_train_launches"] = dp_training[entry["name"]]
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
