"""Host side of the Hopper GEMM core (``csrc/sm90_gemm.cuh``) that K1, K2, K4,
K5, K6 and K7 run on.

The core computes ``out[b, r, n] = epilogue(sum_k A'[b, r, k] * B[n, k])``
with A read through a 3-D TMA tensor map ``[batch, rows, width]`` and B
K-major ``[N, K]``.  The arithmetic the kernels trust is planned here, in
plain Python that the CPU tests reach:

* :func:`k_major` and :func:`paired_k_major` build, once per set of weights,
  the K-major copies of the JAX layouts' ``[K, N]`` product weights; a paired
  copy puts the first half's columns ``Pp..`` and the second half's ``Pp..``
  in tile ``p`` of 2P columns (P = :func:`pair_width`, 128 or 64), so that an
  epilogue holds both halves of a column (gate and filter, out and gate) in
  one thread.  :func:`unpair_k_major` undoes it.
* :func:`row_plan` is the producer's coordinate plan: which A columns and
  which row shift each 64-wide K block loads, tap ``j`` at the row shift
  ``tap_row[j]`` of the core's tap table (TMA fills rows outside ``[0,
  rows)`` with zeros).  :func:`tap_plan` is K1's and K4's table (taps
  centred, ``(j - taps // 2) * dil``); :func:`kept_taps` and
  :func:`tap_rows` are a conv's for K2 and K6: its taps that are not all
  zero, at ``j * d - pad_l``.  :func:`tap_k` is one tap's K (the width
  rounded up to 64; TMA fills A's columns past the width with zeros) and
  :func:`tap_k_major` the kept taps' K-major copy, zero past the width.
* :func:`map_plan` is a tensor map's dims, byte strides and box;
  :func:`check_operand` raises on what TMA refuses (16-byte aligned base and
  strides).  :func:`store_map_plan` is the box of the persistent entry's TMA
  stores (K7), :func:`persistent_config` its ring and epilogue buffer in
  shared memory and :func:`persistent_tiles` its blocks' walk over the tiles.
* :class:`Prepared` is a ``prepare_weights`` tuple that also keeps the
  K-major copies and their encoded tensor maps, built (and the weights
  checked) at the first launch; :func:`kept_on` keeps such operands on one
  weight tensor (K2's and K6's convs); :class:`MapCache` keeps the
  activations' maps.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple
from typing import Callable, List, Sequence, Tuple

import torch

from . import build

BM = 128     # rows of an output tile
BK = 64      # K of a pipeline stage: one 128-byte swizzle row of bf16
PAIR = 64    # columns of each half in a paired tile, at the least
MAP_BYTES = 128  # sizeof(CUtensorMap)
MAX_TAPS = 64    # rows of the core's tap table (sm90::kMaxTaps)
MAX_REACH = 1 << 30  # (k - 1) * d of a tap conv: its row shifts are 32-bit
STORE_BOX_BYTES = 128  # a store box's row: the 128-byte swizzle span (sm90::kBox)
STORE_BOX_ROWS = 64    # a store box's rows: one consumer warpgroup's (sm90::kBoxRows)
SMEM_LIMIT = 232448    # dynamic shared memory a block can have on an H100
SMS = 132              # SMs of an H100 SXM: the persistent grid's blocks at most
PERSISTENT_ROUNDS = 2  # epilogue rounds of a persistent tile (sm90::PersistentConfig::kRounds)


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


def row_plan(a_k: int, tap_row: Sequence[int]) -> List[Tuple[int, int]]:
    """``(A column, row shift)`` of each 64-wide block of the ``K =
    len(tap_row) * a_k`` reduction, as the producer thread computes them."""
    if a_k % BK:
        raise ValueError(f"A's width must be a multiple of {BK}, got {a_k}")
    blocks = a_k // BK
    return [((kb % blocks) * BK, tap_row[kb // blocks]) for kb in range(len(tap_row) * blocks)]


def tap_plan(a_k: int, taps: int, dil: int) -> List[Tuple[int, int]]:
    """:func:`row_plan` of K1's and K4's centred taps: tap ``j`` at ``(j -
    taps // 2) * dil``."""
    return row_plan(a_k, [(j - taps // 2) * dil for j in range(taps)])


def tap_k(width: int) -> int:
    """One tap's K: ``width`` rounded up to a multiple of 64."""
    return -(-width // BK) * BK


def kept_taps(taps: torch.Tensor) -> List[int]:
    """Indices of the taps of ``[k, C_in, C_out]`` that are not all zero (a
    time-folded dilated conv has all-zero taps); tap 0 if every one is."""
    nonzero = taps.reshape(taps.shape[0], -1).ne(0).any(dim=1)
    return [j for j, keep in enumerate(nonzero.tolist()) if keep] or [0]


def check_tap_conv(fn: str, k: int, d: int, pad_l: int) -> None:
    """The geometry a tap conv takes: d >= 1, 0 <= pad_l <= (k - 1) * d, a
    reach below :data:`MAX_REACH`."""
    if d < 1 or not 0 <= pad_l <= (k - 1) * d or (k - 1) * d >= MAX_REACH:
        raise ValueError(f"{fn}: a conv needs d >= 1, 0 <= pad_l <= (k - 1) * d < {MAX_REACH}, "
                         f"got k={k}, d={d}, pad_l={pad_l}")


def tap_rows(kept: Sequence[int], d: int, pad_l: int) -> List[int]:
    """The core's tap table of a conv: kept tap ``j`` reads rows ``t + j * d
    - pad_l``."""
    return [j * d - pad_l for j in kept]


def tap_k_major(taps: torch.Tensor, kept: Sequence[int]) -> torch.Tensor:
    """``[k, C_in, C_out]`` taps -> K-major ``[C_out, len(kept) * tap_k(C_in)]``
    of the kept taps: K index ``i * a_k + c`` is kept tap ``i``'s input
    channel ``c``, zero for ``c >= C_in``."""
    _, c_in, c_out = taps.shape
    out = taps.new_zeros(c_out, len(kept), tap_k(c_in))
    out[:, :, :c_in] = taps[list(kept)].permute(2, 0, 1)
    return out.reshape(c_out, -1)


def map_plan(t: torch.Tensor, box_rows: int):
    """(dims innermost first, byte strides of dims 1 and 2, box) of the 3-D
    tensor map of a contiguous ``[rows, cols]`` or ``[batch, rows, cols]``."""
    batch, rows, cols = (1, *t.shape) if t.dim() == 2 else tuple(t.shape)
    es = t.element_size()
    return (cols, rows, batch), (cols * es, rows * cols * es), (BK, box_rows, 1)


def store_map_plan(t: torch.Tensor):
    """(dims, byte strides, box) of the store map of a contiguous f32 or bf16
    ``[rows, cols]`` or ``[batch, rows, cols]``: boxes of one 128-byte swizzle
    span of a row (32 f32 or 64 bf16 columns) by 64 rows, one warpgroup's
    rows of a tile."""
    dims, strides, _ = map_plan(t, BM)
    return dims, strides, (STORE_BOX_BYTES // t.element_size(), STORE_BOX_ROWS, 1)


def persistent_config(bn: int, paired: bool, out_bytes: int):
    """``(stages, buffer bytes of a warpgroup, shared bytes)`` of the
    persistent entry (``sm90::PersistentConfig``): the epilogue buffer holds
    one round's share of each warpgroup's columns (half of them, written in
    :data:`PERSISTENT_ROUNDS` rounds), in whole 128-byte boxes of 64 rows,
    and the ring takes up to 5 stages of what is left."""
    out_cols = bn // 2 if paired else bn
    chunk = out_cols // PERSISTENT_ROUNDS * out_bytes
    if chunk % STORE_BOX_BYTES:
        raise ValueError(f"a round of {chunk} bytes a row is not whole boxes")
    buf = chunk // STORE_BOX_BYTES * STORE_BOX_ROWS * STORE_BOX_BYTES
    stage = (BM + bn) * BK * 2
    stages = min((SMEM_LIMIT - 1024 - 2 * 8 * 8 - 2 * buf) // stage, 5)
    return stages, buf, stages * stage + 2 * buf + 1024 + 2 * stages * 8


def persistent_tiles(rows: int, cols: int, bn: int, batch: int, sms: int = SMS):
    """The persistent entry's grid and each block's tiles, in order, as
    ``(batch, m_tile, n_tile)``: tile ``blockIdx.x + i * gridDim.x`` of a
    raster with N fastest, then rows, then batch."""
    n_tiles, m_tiles = -(-cols // bn), -(-rows // BM)
    tiles = n_tiles * m_tiles * batch
    grid = min(tiles, sms)
    return grid, [[(t // (n_tiles * m_tiles), (t // n_tiles) % m_tiles, t % n_tiles)
                   for t in range(block, tiles, grid)] for block in range(grid)]


def check_operand(fn: str, name: str, t: torch.Tensor, hint: str = "",
                  reader: str = "TMA") -> None:
    """What an operand that ``reader`` reads must be: contiguous, its base
    and row stride 16-byte aligned.  ``reader`` is TMA for a tensor map's
    operand, or the vector loads of a kernel that indexes rows itself."""
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous ({reader}){hint}")
    if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
        raise ValueError(f"{fn}: {name} must be 16-byte aligned, base and rows ({reader}){hint}")


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


def encode_store(lib_name: str, t: torch.Tensor) -> ctypes.Array:
    """The store map of f32 or bf16 ``t`` for the core's persistent entry
    (:func:`store_map_plan`), encoded through ``lib_name``'s
    ``sm90_encode_store_map``; keep ``t`` alive with it."""
    dims, strides, _ = store_map_plan(t)
    buf = ctypes.create_string_buffer(MAP_BYTES)
    status = function(lib_name, "sm90_encode_store_map", _ENCODE_ARGTYPES)(
        ctypes.addressof(buf), t.data_ptr(), *dims, *strides, t.element_size())
    build.check(status, "cuTensorMapEncodeTiled (store)")
    return buf


class MapCache:
    """Tensor maps of activations, keyed by (address, shape, box rows): a map
    holds nothing else, so a hit is the same map.  A sampler loop meets the
    same few scratch addresses again and again, and skips their encoding."""

    def __init__(self, lib_name: str, size: int = 64):
        self.lib_name, self.size, self.maps = lib_name, size, {}

    def get(self, t: torch.Tensor, box_rows: int) -> ctypes.Array:
        """The load map of :func:`encode` (boxes of 64 columns x ``box_rows``)."""
        return self._get(t, box_rows)

    def get_store(self, t: torch.Tensor) -> ctypes.Array:
        """The store map of :func:`encode_store`."""
        return self._get(t, None)

    def _get(self, t: torch.Tensor, box_rows) -> ctypes.Array:
        key = (t.data_ptr(), tuple(t.shape), t.dtype, box_rows)
        buf = self.maps.get(key)
        if buf is None:
            if len(self.maps) >= self.size:
                self.maps.clear()
            buf = self.maps[key] = (encode_store(self.lib_name, t) if box_rows is None
                                    else encode(self.lib_name, t, box_rows))
        return buf


def tile_n(n: int) -> int:
    """The N tile of a plain product: 256 where it divides N, else 128."""
    return 256 if n % 256 == 0 else 128


class Prepared(tuple):
    """A ``prepare_weights`` tuple.  On the card it also keeps the GEMM core's
    operands (K-major copies and their tensor maps), built by ``make`` at the
    first launch and reused by every later launch that passes the same
    ``make`` (K1, K5 and K7 pass ``lynx_conv.kernel_operands``); the tuple
    itself is unchanged, so every kernel that reads it reads the same
    tensors."""

    def operands(self, make: Callable[["Prepared"], tuple]) -> tuple:
        cache = self.__dict__.setdefault("_sm90", {})
        ops = cache.get(make)
        if ops is None:
            ops = cache[make] = make(self)
        return ops


def kept_on(t: torch.Tensor, make: Callable[[torch.Tensor], tuple]) -> tuple:
    """``make(t)``, built at the first call and kept on the tensor ``t``; built
    again only if ``t`` was written in place since (its version counter)."""
    entry = t.__dict__.get("_sm90")
    if entry is None or entry[0] != t._version:
        entry = t.__dict__["_sm90"] = (t._version, make(t))
    return entry[1]


TapConv = namedtuple("TapConv", "device L kept kept_c wk map_w bn")


def tap_conv(lib_name: str, taps: torch.Tensor) -> TapConv:
    """A conv's operands on the core, from its bf16 ``[k, L, L]`` taps on the
    card: the kept taps (a list and a C array), their K-major copy
    (:func:`tap_k_major`) and its tensor map, box rows = the N tile."""
    L = taps.shape[-1]
    kept = kept_taps(taps)
    if len(kept) > MAX_TAPS:
        raise ValueError(f"the GEMM core takes at most {MAX_TAPS} taps that are not all zero, "
                         f"got {len(kept)}")
    wk = tap_k_major(taps, kept)
    bn = tile_n(L)
    return TapConv(taps.device, L, kept, (ctypes.c_int * len(kept))(*kept), wk,
                   encode(lib_name, wk, bn), bn)
