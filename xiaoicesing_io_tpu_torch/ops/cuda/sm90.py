"""Host side of the Hopper GEMM core (``csrc/sm90_gemm.cuh``) that K1 and K4 run on.

The core computes ``out[b, r, n] = epilogue(sum_k A'[b, r, k] * B[n, k])``
with A read through a 3-D TMA tensor map ``[batch, rows, a_k]`` and B K-major
``[N, K]``.  The arithmetic the kernels trust is planned here, in plain
Python that the CPU tests reach:

* :func:`k_major` and :func:`paired_k_major` build, once per set of weights,
  the K-major copies of the JAX layouts' ``[K, N]`` product weights; a paired
  copy puts the first half's columns ``Pp..`` and the second half's ``Pp..``
  in tile ``p`` of 2P columns (P = :func:`pair_width`, 128 or 64), so that an
  epilogue holds both halves of a column (gate and filter, out and gate) in
  one thread.  :func:`unpair_k_major` undoes it.
* :func:`tap_plan` is the producer's coordinate plan: which A columns and
  which row shift each 64-wide K block loads (tap ``j`` of ``taps`` reads rows
  shifted by ``(j - taps // 2) * dil``; TMA fills rows outside ``[0, rows)``
  with zeros).
* :func:`map_plan` is a tensor map's dims, byte strides and box;
  :func:`check_operand` raises on what TMA refuses (16-byte aligned base and
  strides).
* :class:`Prepared` is a ``prepare_weights`` tuple that also keeps the
  K-major copies and their encoded tensor maps, built (and the weights
  checked) at the first launch; :class:`MapCache` keeps the activations'
  maps.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Sequence, Tuple

import torch

from . import build

BM = 128     # rows of an output tile
BK = 64      # K of a pipeline stage: one 128-byte swizzle row of bf16
PAIR = 64    # columns of each half in a paired tile, at the least
MAP_BYTES = 128  # sizeof(CUtensorMap)


def pair_width(half: int) -> int:
    """Columns of each half in a paired tile: 128 (a 256-column tile) where
    they divide the half, else 64."""
    return 128 if half % 128 == 0 else PAIR


def paired_order(half: int, pair: int) -> torch.Tensor:
    """Original column of each paired column of a ``[K, 2 * half]`` weight:
    tile ``p`` is columns ``pair * p ..`` of the first half, then ``half +
    pair * p ..``."""
    if half % pair:
        raise ValueError(f"a paired weight needs half % {pair} == 0, got {half}")
    return torch.arange(2 * half).view(2, half // pair, pair).transpose(0, 1).reshape(-1)


def k_major(w: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` -> ``[N, K]``, contiguous: row n holds output column n's weights."""
    return w.t().contiguous()


def paired_k_major(w: torch.Tensor, pair: int) -> torch.Tensor:
    """``[K, 2H]`` -> K-major ``[2H, K]`` in :func:`paired_order`."""
    return w.t()[paired_order(w.shape[1] // 2, pair).to(w.device)].contiguous()


def unpair_k_major(wt: torch.Tensor, pair: int) -> torch.Tensor:
    """Inverse of :func:`paired_k_major`."""
    order = paired_order(wt.shape[0] // 2, pair).to(wt.device)
    return wt[torch.argsort(order)].t().contiguous()


def tap_plan(a_k: int, taps: int, dil: int) -> List[Tuple[int, int]]:
    """``(A column, row shift)`` of each 64-wide block of the ``K = taps *
    a_k`` reduction, as the producer thread computes them."""
    if a_k % BK:
        raise ValueError(f"A's width must be a multiple of {BK}, got {a_k}")
    blocks = a_k // BK
    return [((kb % blocks) * BK, (kb // blocks - taps // 2) * dil) for kb in range(taps * blocks)]


def map_plan(t: torch.Tensor, box_rows: int):
    """(dims innermost first, byte strides of dims 1 and 2, box) of the 3-D
    tensor map of a contiguous ``[rows, cols]`` or ``[batch, rows, cols]``."""
    batch, rows, cols = (1, *t.shape) if t.dim() == 2 else tuple(t.shape)
    es = t.element_size()
    return (cols, rows, batch), (cols * es, rows * cols * es), (BK, box_rows, 1)


def check_operand(fn: str, name: str, t: torch.Tensor, hint: str = "") -> None:
    """What a TMA operand must be: contiguous, its base and row stride 16-byte aligned."""
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous{hint}")
    if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
        raise ValueError(f"{fn}: {name} must be 16-byte aligned, base and rows (TMA){hint}")


_ENCODE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 5 + [ctypes.c_int]
_functions = {}


def function(lib_name: str, fn_name: str, argtypes: Sequence) -> Callable:
    """``lib_name``'s C entry point with its argument types set once."""
    key = (lib_name, fn_name)
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(build.load(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn


def encode(lib_name: str, t: torch.Tensor, box_rows: int) -> ctypes.Array:
    """The tensor map of bf16 ``t`` (:func:`map_plan`), encoded by
    ``cuTensorMapEncodeTiled`` through ``lib_name``'s ``sm90_encode_map``;
    keep ``t`` alive with it."""
    dims, strides, box = map_plan(t, box_rows)
    buf = ctypes.create_string_buffer(MAP_BYTES)
    status = function(lib_name, "sm90_encode_map", _ENCODE_ARGTYPES)(
        ctypes.addressof(buf), t.data_ptr(), *dims, *strides, box[1])
    build.check(status, "cuTensorMapEncodeTiled")
    return buf


class MapCache:
    """Tensor maps of activations, keyed by (address, shape, box rows): a map
    holds nothing else, so a hit is the same map.  A sampler loop meets the
    same few scratch addresses again and again, and skips their encoding."""

    def __init__(self, lib_name: str, size: int = 64):
        self.lib_name, self.size, self.maps = lib_name, size, {}

    def get(self, t: torch.Tensor, box_rows: int) -> ctypes.Array:
        key = (t.data_ptr(), tuple(t.shape), box_rows)
        buf = self.maps.get(key)
        if buf is None:
            if len(self.maps) >= self.size:
                self.maps.clear()
            buf = self.maps[key] = encode(self.lib_name, t, box_rows)
        return buf


def tile_n(n: int) -> int:
    """The N tile of a plain product: 256 where it divides N, else 128."""
    return 256 if n % 256 == 0 else 128


class Prepared(tuple):
    """A ``prepare_weights`` tuple.  On the card it also keeps the GEMM core's
    operands (K-major copies and their tensor maps), built by ``make`` at the
    first launch and reused by every later one; the tuple itself is
    unchanged, so every kernel that reads it reads the same tensors."""

    def operands(self, make: Callable[["Prepared"], tuple]) -> tuple:
        ops = self.__dict__.get("_sm90")
        if ops is None:
            ops = self.__dict__["_sm90"] = make(self)
        return ops
