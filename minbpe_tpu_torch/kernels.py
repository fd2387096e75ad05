"""The CUDA kernels of the main path, their build, bindings and plain twins.

Fifteen kernels (csrc/bpe_kernels.cu) carry training and encode over a dense
token stream (ids, seg) whose live length n is an int32[1] tensor on the
same device, so a whole run launches without a host sync per merge:

- ``pair_stats``     K1: exact pair counts and first positions (V x V);
- ``select_batch``   K5: the selection walk of one count rebuild: up to
  K_CAP candidates in the reference's order, stopped at the first one that
  cannot join the batch;
- ``merge_apply``    K3: apply one merge everywhere, left first (from a
  carry-in of 0 or 1 tokens, in the distributed trainer);
- ``batch_hist``     K6: the batch's sites and both creation histograms,
  in one pass;
- ``batch_apply``    K8: the trim, then the batch's combined apply, in one
  launch;
- ``compact``        K4: order-preserving compaction by the live mask;
- ``pair_count``     K9: the dense V x V pair-count matrix of the selection
  paths and the stepped trainer's first count;
- ``encode_sweep``   K10: the encoder's whole rank sweep, every merge of a
  table applied and compacted in turn, in one cooperative launch;
- ``chunk_encode``   K11: encode with a table above the dense route's vocab
  (a cuckoo pair table, ops/ranktab.py), chunks of at most CHUNK_WARP_MAX
  tokens: one lane a chunk of up to 8, one warp a longer one;
- ``encode_min_sweep`` K12: the same for longer chunks, each chunk's own
  lowest-rank loop in one block or one thread-block cluster (``k12_plan``),
  all in one launch;
- ``segment_encode`` K17: the encode of a stream cut into many segments
  (a pre-split text), each segment by its own lowest-rank loop through the
  table's cuckoo pairs (K11's lane and warp bodies), the output compacted
  in place of K10's, in one launch; any table, dense or sorted;
- ``pair_select``    K13: one round of the sort-round trainer: every pair's
  count and first position into a device hash table (``PairTable``), then
  the round's pair and record, leaving the table empty, in one cooperative
  launch;
- ``pair_summaries`` K16: the distributed trainer's sparse and owner
  selections on K13's table: a rank's distinct pairs as summary rows
  (a, b, count, first position), and ``pair_summaries_merge``, the
  champion of gathered rows, one cooperative launch each;
- ``presplit_succ`` and ``presplit_orbit`` K15: the GPT-2 / GPT-4
  pre-split of raw UTF-8 bytes, every char start's chunk end, then the
  chunk starts as segment ids, and given a 256-entry byte table each
  byte's token id beside them (ops/device_presplit.py holds their
  wrappers and plain twins); ``presplit_cluster``, both in one launch of
  one thread-block cluster, a CTA a tile of 512 to 4,096 bytes, for a
  stream of at most ``PRESPLIT_CLUSTER_MAX`` tiles of 4,096.

K1 and K9 share one counting core: each block of a persistent grid counts
one contiguous range of the stream into a hash table of pairs in shared
memory and adds it into the matrices with one global atomic per distinct
pair (K1 also a min of first positions). K13 counts the same way into a
hash table in device memory, one insert per distinct pair of a block.

K6 walks the live tiles of the stream with a persistent grid and keeps
each block's histograms in shared memory; the trainer makes its ``cand``
once per run.

K5 and K8 each hand their blocks' partial results to the last block to
finish through a done counter in a scratch tensor that the trainer makes
once per run (``select_scratch``, ``batch_scratch``); that block leaves it
zero again, so no launch clears it first. K13's blocks hand theirs to
block 0 across a grid barrier, through the ``PairTable``'s scratch.

K3, K4 and K17 chain their tiles with a decoupled look-back over status
words that persist per stream (``_lookback_state``); each call tags them
with a new generation, so no call clears them first.

Training state lives in two small device tensors: ``ctl`` (merges done,
fail round, rebuilds; see ``new_ctl``) and the slot record ``slot`` that K5
writes for the kernels after it (``new_slot``). The trainer's kernels read
them and return at once where they have nothing to do, so the host enqueues
rebuild slots blind.

Each wrapper takes the same tensors on either device. A CUDA tensor goes to
the kernel (or the wrapper raises); a CPU tensor goes to the plain PyTorch
version beside it, which is also what the kernel is held against on the
card. Only a kernel launch adds to the wrapper's ``launches`` count.

The shared library is built with nvcc from the package's own source at the
first CUDA launch (or by ``build()``) into ``_build/``, and bound with
ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .ops.ranktab import RANK_INF

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "bpe_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# positions per tile of K3, K4 and K10 (bpe_tile_size() on the card)
TILE = 2048
# positions a K17 block owns (a window of 32 a warp): its look-back tile
# (bpe_segment_tile() on the card)
SEGMENT_TILE = 256
INT32_MAX = 2**31 - 1
# the longest chunk K11 takes (CHUNK_MAX on the card), and the longest one
# lane of it takes (LANE_MAX)
CHUNK_WARP_MAX = 256
K11_LANE_MAX = 8
# the batch (fused_train.py:398 K_CAP) and its creation histograms
K_CAP = 16
HIST_BUCKETS = 128
# ctl words (csrc/bpe_kernels.cu)
CTL_I, CTL_FAIL, CTL_REBUILDS = 0, 1, 2
CTL_SIZE = 4
# slot record words
SLOT_PAIRS = 0
SLOT_COUNT = 2 * K_CAP
SLOT_BSEL = 3 * K_CAP
SLOT_ZBASE = SLOT_BSEL + 1
SLOT_I = SLOT_BSEL + 2
SLOT_BSTAR = SLOT_BSEL + 3
SLOT_SIZE = 64
# bytes a tile of K15's two kernels, and ints of presplit_succ's scratch a
# block of its grid (bpe_presplit_tile_size() and bpe_presplit_scratch_ints()
# on the card)
PRESPLIT_TILE = 4096
PRESPLIT_SCRATCH_INTS = 6
# presplit_orbit marks the path over its node graph in one block up to
# this many nodes (every distinct exit of every tile), else grid-wide
# (bpe_presplit_block_nodes() on the card)
PRESPLIT_BLOCK_NODES = 4096
# presplit_cluster takes a stream of at most this many tiles, one CTA a
# tile in one cluster, its tiles of this many bytes up to PRESPLIT_TILE
# (bpe_presplit_cluster_max() and bpe_presplit_cluster_min_tile() on the
# card)
PRESPLIT_CLUSTER_MAX = 8
PRESPLIT_CLUSTER_MIN_TILE = 512


class KernelInfo:
    """What the records say about one kernel, and its launch count."""

    def __init__(self, name: str, replaces: str):
        self.name = name
        self.replaces = replaces
        self.source = "minbpe_tpu_torch/csrc/bpe_kernels.cu"
        self.launches = 0


PAIR_STATS = KernelInfo(
    "pair_stats",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: tiled_adjacency "
    ":251-290, count_width/count_blocked/count_full :816-891); "
    "minbpe_tpu/ops/pallas/fused_train_xl.py:74 (_adjcount_kernel)")
SELECT_BATCH = KernelInfo(
    "select_batch",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: select_candidate "
    ":915-1000, sel_body :1042-1084, no_pair :1118-1123); "
    "minbpe_tpu/ops/pallas/fused_train_xl.py:176 (_tie_kernel), :158-173 "
    "(_adjcount_kernel's _select), :689-731 (_train_xl's walk)")
MERGE_APPLY = KernelInfo(
    "merge_apply",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: tiled_apply "
    ":293-340); minbpe_tpu/ops/pallas/fused_train_xl.py:247 "
    "(_apply_kernel)")
BATCH_HIST = KernelInfo(
    "batch_hist",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: tiled_batch_mark "
    ":452-521, tiled_batch_hist_rev :524-593); minbpe_tpu/ops/pallas/"
    "fused_train_xl.py:328 (_mark_kernel), :392 (_histrev_kernel)")
BATCH_APPLY = KernelInfo(
    "batch_apply",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: trim :1140-1153, "
    "tiled_batch_apply :596-634); minbpe_tpu/ops/pallas/fused_train_xl.py"
    ":442 (_batch_apply_kernel)")
COMPACT = KernelInfo(
    "compact",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: _compact_inplace "
    ":641-736); minbpe_tpu/ops/pallas/fused_train_xl.py:300 "
    "(_compact_kernel)")
PAIR_COUNT = KernelInfo(
    "pair_count",
    "minbpe_tpu/ops/pallas/pair_count.py:29 (_kernel, launched by "
    "count_pairs_pallas :56-90)")
ENCODE_SWEEP = KernelInfo(
    "encode_sweep",
    "minbpe_tpu/ops/pallas/fused_encode.py:45 (_kernel, pallas_call :137)")
CHUNK_ENCODE = KernelInfo(
    "chunk_encode",
    "minbpe_tpu/ops/flat_encode.py:61 (_encode_flat, a jitted "
    "lax.while_loop over scan2d; no Pallas site): its chunks of at most "
    "256 tokens")
ENCODE_MIN_SWEEP = KernelInfo(
    "encode_min_sweep",
    "minbpe_tpu/ops/flat_encode.py:61 (_encode_flat, a jitted "
    "lax.while_loop over scan2d; no Pallas site): its chunks of more than "
    "256 tokens")
SEGMENT_ENCODE = KernelInfo(
    "segment_encode",
    "no Pallas site of its own: the dense route's use of "
    "minbpe_tpu/ops/pallas/fused_encode.py:45 (_kernel) on a stream cut "
    "into many segments; each segment takes minbpe_tpu/ops/flat_encode.py"
    ":61's per-chunk rule (_encode_flat)")
PAIR_SELECT = KernelInfo(
    "pair_select",
    "minbpe_tpu/ops/train_sortloop.py:49 (_round, a jitted lax.fori_loop "
    "body; no Pallas site): its stable lax.sort of (a, b, position) and run "
    "scans, :62-76, and its selection, :70-78 (largest count, then earliest "
    "first occurrence)")
_PRESPLIT = ("minbpe_tpu/ops/device_presplit.py:208 (_presplit_device, a "
             "jitted jnp program; no Pallas site): ")
PRESPLIT_SUCC = KernelInfo(
    "presplit_succ",
    _PRESPLIT + "_decode_utf8 :74-90, _char_flags :93-98, _successor "
    ":117-205")
PRESPLIT_ORBIT = KernelInfo(
    "presplit_orbit",
    _PRESPLIT + "_orbit :101-114 and the boundaries and segment ids "
    ":221-233")
PRESPLIT_CLUSTER = KernelInfo(
    "presplit_cluster",
    _PRESPLIT + "the whole program, :74-233, on a stream of at most "
    "PRESPLIT_CLUSTER_MAX tiles")
PAIR_SUMMARIES = KernelInfo(
    "pair_summaries",
    "minbpe_tpu/parallel/train.py:229 (_local_run_summaries, a jitted "
    "lax.sort and run scans; no Pallas site), and the merges of "
    "_sparse_global_select :272-301 and _owner_global_select :355-374")
KERNELS = (PAIR_STATS, SELECT_BATCH, MERGE_APPLY, BATCH_HIST, BATCH_APPLY,
           COMPACT, PAIR_COUNT, ENCODE_SWEEP, CHUNK_ENCODE, ENCODE_MIN_SWEEP,
           PAIR_SELECT, PRESPLIT_SUCC, PRESPLIT_ORBIT, PAIR_SUMMARIES,
           SEGMENT_ENCODE, PRESPLIT_CLUSTER)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

# the C entry points of csrc/bpe_kernels.cu and their argument types, as
# ctypes passes them (a pointer or a stream as c_void_p, an int as c_int, a
# hash seed as c_uint)
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
SIGNATURES = {
    "bpe_tile_size": [],
    "bpe_segment_tile": [],
    "bpe_select_blocks": [_I],
    "bpe_pair_stats": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bpe_select_batch": [_P, _P, _I, _P, _P, _P, _P, _P],
    "bpe_merge_apply": [_P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P,
                        _P, _I, _P],
    "bpe_batch_hist": [_P, _P, _P, _P, _I, _P, _P, _P],
    "bpe_batch_apply": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "bpe_compact": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P],
    "bpe_encode_grid": [_I],
    "bpe_encode_sweep": [_P, _P, _I, _P, _P, _I, _P,
                         _P, _P, _P, _P, _I, _P, _P],
    "bpe_chunk_encode": [_P, _P, _P, _I, _I, _P, _I, _U, _U, _U, _U, _P, _P,
                         _P, _P],
    "bpe_encode_min_sweep": [_P, _P, _P, _P, _I, _I, _P, _I, _U, _U, _U, _U,
                             _P, _P, _P, _P, _P, _I, _P],
    "bpe_segment_encode": [_P, _P, _I, _P, _I, _U, _U, _U, _U, _P, _P, _P,
                           _P, _P, _P, _P, _I, _P],
    "bpe_pair_count": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bpe_pair_hist_grid": [_I, _I, _I],
    "bpe_pair_select_grid": [],
    "bpe_pair_select": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                        _I, _P],
    "bpe_pair_summaries_grid": [],
    "bpe_pair_summaries": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P,
                           _P, _I, _P],
    "bpe_pair_summaries_merge": [_P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I,
                                 _P],
    "bpe_presplit_tile_size": [],
    "bpe_presplit_stamps": [_P],
    "bpe_presplit_scratch_ints": [],
    "bpe_presplit_block_nodes": [],
    "bpe_presplit_grid": [_I],
    "bpe_presplit_succ": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P],
    "bpe_presplit_orbit": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _I, _P],
    "bpe_presplit_cluster_max": [],
    "bpe_presplit_cluster_min_tile": [],
    "bpe_presplit_cluster": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                             _I, _I, _P],
}

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    """Build output, keyed by the source's and the flags' content."""
    h = hashlib.sha256(open(SOURCE, "rb").read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbpe_kernels-{h.hexdigest()[:12]}.so")


def build_command(out: str) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", out, SOURCE]


def build() -> str:
    """Compile the kernels unless this source is already built; returns the
    library path. Raises if nvcc is missing or fails."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, got, want in (
                ("tile", lib.bpe_tile_size(), TILE),
                ("segment tile", lib.bpe_segment_tile(), SEGMENT_TILE),
                ("pre-split tile", lib.bpe_presplit_tile_size(),
                 PRESPLIT_TILE),
                ("pre-split scratch", lib.bpe_presplit_scratch_ints(),
                 PRESPLIT_SCRATCH_INTS),
                ("pre-split block nodes", lib.bpe_presplit_block_nodes(),
                 PRESPLIT_BLOCK_NODES),
                ("pre-split cluster", lib.bpe_presplit_cluster_max(),
                 PRESPLIT_CLUSTER_MAX),
                ("pre-split cluster tile",
                 lib.bpe_presplit_cluster_min_tile(),
                 PRESPLIT_CLUSTER_MIN_TILE)):
            if got != want:
                raise RuntimeError(f"the kernels' {name} is {got}, "
                                   f"kernels.py's {want}")
        _lib = lib
        return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run(device, fn, *args):
    """Launch on ``device``'s current stream, with it as the current device
    (the C entry points launch on the current device)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _check(name, t, dtype, device, min_numel=1):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.numel() < min_numel:
        raise ValueError(f"{name}: needs at least {min_numel} elements")


def _check_stream(ids, seg, n):
    _check("ids", ids, torch.int32, ids.device, 0)
    _check("seg", seg, torch.int32, ids.device, 0)
    _check("n", n, torch.int32, ids.device)
    if seg.numel() < ids.numel():
        raise ValueError("seg is shorter than ids")


def _check_state(ctl=None, slot=None, log=None, device=None):
    if ctl is not None:
        _check("ctl", ctl, torch.int32, device, CTL_SIZE)
    if slot is not None:
        _check("slot", slot, torch.int32, device, SLOT_SIZE)
    if log is not None:
        _check("log", log, torch.int32, device, 4)
        if log.dim() != 2 or log.shape[1] != 4:
            raise ValueError("log: must be (M, 4)")


def _tiles(cap: int, tile: int = TILE) -> int:
    return max(1, -(-cap // tile))


# K3's, K4's and K17's look-back state, per (device, stream): [tensor,
# last generation]
_LOOKBACK: dict = {}
_LOOKBACK_LOCK = threading.Lock()
_GEN_MAX = (1 << 30) - 1


def _lookback_state(device, cap: int, tile: int = TILE):
    """(state, gen) for one K3, K4 or K17 launch over cap positions, in
    tiles of ``tile``, on ``device``'s current stream: state is
    int64[1 + tiles], word 0 the tile counter (each launch leaves it 0),
    then a status word per tile, zeroed once when it is allocated or
    grown; gen is this call's generation (1 .. 2^30 - 1), which tells the
    launch's status words from those left by earlier ones. Each stream has its own state, and launches on one
    stream run in order, so no two launches in flight share it."""
    tiles = _tiles(cap, tile)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    with _LOOKBACK_LOCK:
        ent = _LOOKBACK.get(key)
        if ent is None or ent[0].numel() < 1 + tiles:
            ent = [torch.zeros(1 + tiles, dtype=torch.int64, device=device),
                   0 if ent is None else ent[1]]
            _LOOKBACK[key] = ent
        ent[1] = ent[1] % _GEN_MAX + 1
        return ent[0], ent[1]


def new_ctl(num_merges: int, device) -> torch.Tensor:
    """ctl for a run of num_merges merges: (i = 0, fail = M, rebuilds = 0),
    filled on the device (a host tensor copied there would sync)."""
    ctl = torch.zeros(CTL_SIZE, dtype=torch.int32, device=device)
    ctl[CTL_FAIL] = num_merges
    return ctl


def new_slot(device) -> torch.Tensor:
    return torch.zeros(SLOT_SIZE, dtype=torch.int32, device=device)


def new_hist(device) -> torch.Tensor:
    """The two creation histograms, acc_l then acc_r: (2, 128, K_CAP)."""
    return torch.zeros((2, HIST_BUCKETS, K_CAP), dtype=torch.int32,
                       device=device)


def _select_words(V: int) -> int:
    """Words of K5's scratch for V x V matrices: a done counter, then each
    block's K_CAP keys and K_CAP pairs."""
    blocks = _load().bpe_select_blocks(V)
    if blocks < 1:
        raise ValueError(f"select_batch: V = {V} outside 1 .. 1024")
    return 1 + 2 * blocks * K_CAP


def select_scratch(V: int, device) -> torch.Tensor:
    """K5's scratch, zero; each launch leaves it zero again."""
    if device.type != "cuda":
        return None
    return torch.zeros(_select_words(V), dtype=torch.int64, device=device)


BATCH_SCRATCH = 1 + K_CAP


def batch_scratch(device) -> torch.Tensor:
    """K8's scratch (a done counter and the kept sites per candidate),
    zero; each launch leaves it zero again."""
    if device.type != "cuda":
        return None
    return torch.zeros(BATCH_SCRATCH, dtype=torch.int32, device=device)


def _idle(ctl) -> bool:
    return ctl is not None and int(ctl[CTL_I]) >= int(ctl[CTL_FAIL])


def _gated_off(slot, lo: int, hi: int) -> bool:
    return slot is not None and not lo <= int(slot[SLOT_BSEL]) <= hi


# ---------------------------------------------------------------------------
# K1 pair_stats (K9 shares its counting core, count_pairs in the CUDA source)
# ---------------------------------------------------------------------------

def _check_width(V: int):
    """The kernels index the V x V matrices with 32-bit a * V + b."""
    if not 1 <= V * V < 1 << 31:
        raise ValueError(f"V = {V}: the kernels take 1 <= V * V < 2^31")


def _stats_out(V, device, out):
    if out is not None:
        return out
    return (torch.zeros((V, V), dtype=torch.int32, device=device),
            torch.full((V, V), -1, dtype=torch.int32, device=device))


def pair_stats_plain(ids, seg, n, V: int, ctl=None, out=None):
    """(cnt, first): int32 (V, V) pair counts and first positions (-1 where
    absent) over the countable pairs of ids[:n]. Only the W x W corner is
    rewritten, W = 256 + ctl's i (V without ctl): the ids present are below
    it. ``out`` = (cnt, first) to write into; an idle ctl leaves them."""
    cnt, first = _stats_out(V, ids.device, out)
    if _idle(ctl):
        return cnt, first
    W = V if ctl is None else min(V, 256 + int(ctl[CTL_I]))
    VV = V * V
    nn = int(n.item())
    c = torch.zeros(VV, dtype=torch.int32, device=ids.device)
    f = torch.full((VV,), -1, dtype=torch.int32, device=ids.device)
    if nn >= 2:
        a, b = ids[:nn - 1], ids[1:nn]
        ok = ((seg[:nn - 1] == seg[1:nn]) & (a >= 0) & (a < W)
              & (b >= 0) & (b < W))
        # pairs that do not count go to one extra bin, dropped at the end
        key = torch.where(ok, a.long() * V + b.long(), VV)
        c = torch.bincount(key, minlength=VV + 1)[:VV].to(torch.int32)
        none = 1 << 40
        fl = torch.full((VV + 1,), none, dtype=torch.int64, device=ids.device)
        fl.scatter_reduce_(0, key, torch.arange(nn - 1, device=ids.device),
                           "amin")
        f = torch.where(fl == none, -1, fl)[:VV].to(torch.int32)
    cnt[:W, :W] = c.view(V, V)[:W, :W]
    first[:W, :W] = f.view(V, V)[:W, :W]
    return cnt, first


def pair_stats(ids, seg, n, V: int, ctl=None, out=None):
    if not ids.is_cuda:
        return pair_stats_plain(ids, seg, n, V, ctl, out)
    dev = ids.device
    _check_stream(ids, seg, n)
    _check_state(ctl, device=dev)
    _check_width(V)
    cnt, first = _stats_out(V, dev, out)
    _check("cnt", cnt, torch.int32, dev, V * V)
    _check("first", first, torch.int32, dev, V * V)
    lib = _load()
    _run(dev, lib.bpe_pair_stats, _ptr(ids), _ptr(seg), _ptr(n), _ptr(ctl),
         _ptr(cnt), _ptr(first), V, ids.numel(), 0, 0)
    PAIR_STATS.launches += 1
    return cnt, first


# ---------------------------------------------------------------------------
# K5 select_batch
# ---------------------------------------------------------------------------

def accept_walk(pairs_counts):
    """The selection walk over candidates in descending key order, each
    (pa, pb, count) with count > 0: the accepted prefix
    (fused_train.py:1059-1064)."""
    out = []
    for j, (pa, pb, c) in enumerate(pairs_counts[:K_CAP]):
        if j > 0 and (pa == pb or out[0][0] == out[0][1] or any(
                qa == pb or qb == pa for qa, qb, _ in out)):
            break
        out.append((pa, pb, c))
    return out


def select_batch_plain(cnt, first, ids, ctl, slot, log, scratch=None):
    """Walk the K_CAP largest keys count << 32 | (0xFFFFFFFF - first) of the
    W x W corner (W = 256 + i) and write the slot record: the accepted
    candidates (pa, pb, count), bsel, 256 + i and i. Counts the rebuild;
    sets fail = i when nothing is accepted; a single merge writes log row i
    (kept 0) and advances i. An idle ctl only sets bsel = 0."""
    if _idle(ctl):
        slot[SLOT_BSEL] = 0
        return
    i = int(ctl[CTL_I])
    V = cnt.shape[0]
    W = min(V, 256 + i)
    c = cnt[:W, :W].reshape(-1).long()
    f = first[:W, :W].reshape(-1).long() & 0xFFFFFFFF
    key = torch.where(c > 0, (c << 32) | (0xFFFFFFFF - f),
                      torch.zeros_like(c))
    top = torch.topk(key, min(K_CAP, key.numel())).values.tolist()
    found = []
    for k in top:
        if k == 0:
            break
        pos = 0xFFFFFFFF - (k & 0xFFFFFFFF)
        found.append((int(ids[pos]), int(ids[pos + 1]), k >> 32))
    acc = accept_walk(found)
    bsel = len(acc)
    rec = [-1] * (2 * K_CAP) + [0] * K_CAP
    for j, (pa, pb, cj) in enumerate(acc):
        rec[2 * j], rec[2 * j + 1], rec[SLOT_COUNT + j] = pa, pb, cj
    slot[:SLOT_BSEL] = torch.tensor(rec, dtype=torch.int32)
    slot[SLOT_BSEL:SLOT_BSTAR + 1] = torch.tensor(
        [bsel, 256 + i, i, 1 if bsel == 1 else 0], dtype=torch.int32)
    ctl[CTL_REBUILDS] += 1
    if bsel == 0:
        ctl[CTL_FAIL] = i
    elif bsel == 1:
        log[i] = torch.tensor([*acc[0], 0], dtype=torch.int32)
        ctl[CTL_I] = i + 1


def select_batch(cnt, first, ids, ctl, slot, log, scratch=None):
    if not ids.is_cuda:
        return select_batch_plain(cnt, first, ids, ctl, slot, log)
    dev = ids.device
    V = cnt.shape[0]
    if cnt.dim() != 2 or cnt.shape[1] != V:
        raise ValueError("cnt: must be (V, V)")
    _check("cnt", cnt, torch.int32, dev, V * V)
    _check("first", first, torch.int32, dev, V * V)
    _check("ids", ids, torch.int32, dev, 0)
    _check_state(ctl, slot, log, dev)
    if scratch is None:
        scratch = select_scratch(V, dev)
    _check("scratch", scratch, torch.int64, dev, _select_words(V))
    lib = _load()
    _run(dev, lib.bpe_select_batch, _ptr(cnt), _ptr(first), V, _ptr(ctl),
         _ptr(slot), _ptr(log), _ptr(scratch))
    SELECT_BATCH.launches += 1


# ---------------------------------------------------------------------------
# K3 merge_apply
# ---------------------------------------------------------------------------

def merge_apply_plain(ids, seg, n, pair=None, z: int = 0, kept=None, *,
                      slot=None, log=None, carry=None, gate: bool = False,
                      tf=None, out=None):
    """(ids_out, live): pair (pair[0], pair[1]) -> z at every occurrence in
    ids[:n], left first; live[i] is False for the token consumed by a kept
    match. Adds the kept count to kept[0] when given. With ``slot`` (the
    trainer): only when bsel == 1, the pair is the slot's candidate 0, z its
    256 + i, and the kept count goes to log row i.

    The distributed trainer's carry-in: start = carry[0] (an int32[1]
    tensor; 0 without it) tokens are dropped, taken by the left rank's
    boundary merge: no match starts before start, those tokens are dead,
    and the parity starts at token start. ``gate``: return ``out`` as it is
    where start is 0. ``tf`` (int32[2]): the transfer bits of the last pair
    (n - 2, n - 1): kept, and kept or not, closing a run of matches that
    began at start; zeros where there is no such pair. ``out``: (ids_out,
    live) to write into."""
    start = 0 if carry is None else int(carry[0])
    if gate and start == 0:
        return out
    ids_out = ids.clone()
    live = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    if out is not None:
        ids_out, live = out
        ids_out.copy_(ids)
        live.fill_(True)
    if _gated_off(slot, 1, 1):
        return ids_out, live
    if slot is not None:
        pair, z = slot[:2], int(slot[SLOT_ZBASE])
        kept = log[int(slot[SLOT_I]), 3:4]
    nn = int(n.item())
    pa, pb = int(pair[0]), int(pair[1])
    x = ids[:nn]
    m = torch.zeros(nn, dtype=torch.bool, device=ids.device)
    if nn >= 2:
        m[:-1] = (x[:-1] == pa) & (x[1:] == pb) & (seg[:nn - 1] == seg[1:nn])
    m[:start] = False
    prev = torch.zeros_like(m)
    prev[1:] = m[:-1]
    pos = torch.arange(nn, device=ids.device)
    first = torch.where(m & ~prev, pos, torch.full_like(pos, -1))
    run_start = torch.cummax(first, 0).values if nn else first
    keep = m & ((pos - run_start) % 2 == 0)
    ids_out[:nn] = torch.where(keep, torch.full_like(x, z), x)
    live[1:nn] = ~keep[:-1]
    live[:min(start, nn)] = False
    if kept is not None:
        kept += keep.sum().to(kept.dtype)
    if tf is not None:
        q = nn - 2
        tf.zero_()
        if q >= start:
            tf[0] = int(keep[q])
            tf[1] = int(bool(m[q]) and int(run_start[q]) == start)
    return ids_out, live


def merge_apply(ids, seg, n, pair=None, z: int = 0, kept=None, *, slot=None,
                log=None, carry=None, gate: bool = False, tf=None, out=None):
    if not ids.is_cuda:
        return merge_apply_plain(ids, seg, n, pair, z, kept, slot=slot,
                                 log=log, carry=carry, gate=gate, tf=tf,
                                 out=out)
    dev = ids.device
    _check_stream(ids, seg, n)
    if slot is not None:
        _check_state(slot=slot, log=log, device=dev)
        pair, kept = slot, log
    _check("pair", pair, torch.int32, dev, 2)
    if kept is not None:
        _check("kept", kept, torch.int32, dev)
    if carry is not None:
        _check("carry", carry, torch.int32, dev)
    if tf is not None:
        _check("tf", tf, torch.int32, dev, 2)
    if gate and (carry is None or out is None):
        raise ValueError("merge_apply: gate needs carry and out")
    cap = ids.numel()
    if out is None:
        ids_out = torch.empty_like(ids)
        live = torch.empty(cap, dtype=torch.bool, device=dev)
    else:
        ids_out, live = out
        _check("ids_out", ids_out, torch.int32, dev, cap)
        _check("live", live, torch.bool, dev, cap)
    lib = _load()
    state, gen = _lookback_state(dev, cap)
    _run(dev, lib.bpe_merge_apply, _ptr(ids), _ptr(seg), _ptr(n),
         _ptr(pair), z, _ptr(slot), cap, _ptr(ids_out), _ptr(live),
         _ptr(kept), _ptr(carry), int(gate), _ptr(tf), _ptr(state), gen)
    MERGE_APPLY.launches += 1
    return ids_out, live


# ---------------------------------------------------------------------------
# K6 batch_hist, K8 batch_apply (bsel >= 2)
# ---------------------------------------------------------------------------

def _slot_batch(slot):
    rec = slot.tolist()
    bsel = rec[SLOT_BSEL]
    return ([(rec[2 * j], rec[2 * j + 1]) for j in range(bsel)],
            rec[SLOT_ZBASE], rec)


def _hist_add(acc, v, vid, j, zbase):
    """acc[v & 127, j] += 1 per entry, and acc[vid & 127, j] too where the
    partner v lies in a site (v >= zbase) and the bucket differs."""
    r1 = v & (HIST_BUCKETS - 1)
    r2 = vid & (HIST_BUCKETS - 1)
    two = (v >= zbase) & (r2 != r1)
    idx = torch.cat([r1 * K_CAP + j, (r2 * K_CAP + j)[two]])
    acc += torch.bincount(idx.long(), minlength=HIST_BUCKETS * K_CAP).view(
        acc.shape).to(acc.dtype)


def batch_mark_plain(ids, seg, n, slot, acc_l):
    """(cand, F): cand[p] = j where the slot's candidate j matches at p,
    else -1; F[p] = the id at p after the whole batch (256 + i + j at a
    site start and its consumed token). Adds the left-creation histogram
    to acc_l (128, K_CAP): per site p of j, row F[p-1] & 127, and row
    ids[p-1] & 127 too when p-1 lies in a site. The first half of
    batch_hist_plain."""
    cand = torch.full_like(ids, -1)
    F = ids.clone()
    if _gated_off(slot, 2, K_CAP):
        return cand, F
    pairs, zbase, _ = _slot_batch(slot)
    nn = int(n.item())
    if nn == 0:
        return cand, F
    x, sg = ids[:nn], seg[:nn]
    c = cand[:nn]
    if nn >= 2:
        same = sg[:-1] == sg[1:]
        for j, (pa, pb) in enumerate(pairs):
            c[:-1][same & (x[:-1] == pa) & (x[1:] == pb)] = j
    c1 = torch.full_like(c, -1)
    c1[1:] = c[:-1]
    F[:nn] = torch.where(c >= 0, zbase + c, torch.where(c1 >= 0, zbase + c1,
                                                        x))
    site = c >= 0
    site[0] = False
    site[1:] &= sg[1:] == sg[:-1]
    p = torch.nonzero(site).flatten()
    _hist_add(acc_l, F[p - 1], x[p - 1], c[p], zbase)
    return cand, F


def batch_hist_rev_plain(ids, seg, n, cand, F, slot, acc_r):
    """Adds the right-creation histogram to acc_r (128, K_CAP): per site p
    of j whose second-next token p+2 is in its chunk, row F[p+2] & 127, and
    row ids[p+2] & 127 too when p+2 lies in a site. The second half of
    batch_hist_plain."""
    if _gated_off(slot, 2, K_CAP):
        return
    zbase = int(slot[SLOT_ZBASE])
    nn = int(n.item())
    if nn < 3:
        return
    c = cand[:nn - 2]
    site = (c >= 0) & (seg[2:nn] == seg[:nn - 2])
    p = torch.nonzero(site).flatten()
    _hist_add(acc_r, F[p + 2], ids[p + 2], c[p], zbase)


def batch_hist_plain(ids, seg, n, slot, acc, cand):
    """K6's function: cand[p] for every p < n (cand: int32, at least the
    stream's length; positions from n on are left as they are) and both
    creation histograms added to acc = (acc_l, acc_r), (2, 128, K_CAP):
    batch_mark_plain, then batch_hist_rev_plain, without F. A slot outside
    the batch gate leaves everything as it is. Returns cand."""
    if _gated_off(slot, 2, K_CAP):
        return cand
    h = acc.view(2, HIST_BUCKETS, K_CAP)
    c, F = batch_mark_plain(ids, seg, n, slot, h[0])
    batch_hist_rev_plain(ids, seg, n, c, F, slot, h[1])
    nn = int(n.item())
    cand[:nn] = c[:nn]
    return cand


def batch_hist(ids, seg, n, slot, acc, cand):
    """One launch for the batch's sites and both creation histograms
    (batch_hist_plain). ``cand`` is written, not allocated: the trainer
    makes it once per run."""
    if not ids.is_cuda:
        return batch_hist_plain(ids, seg, n, slot, acc, cand)
    dev = ids.device
    _check_stream(ids, seg, n)
    _check_state(slot=slot, device=dev)
    _check("acc", acc, torch.int32, dev, 2 * HIST_BUCKETS * K_CAP)
    _check("cand", cand, torch.int32, dev, ids.numel())
    lib = _load()
    _run(dev, lib.bpe_batch_hist, _ptr(ids), _ptr(seg), _ptr(n), _ptr(slot),
         ids.numel(), _ptr(cand), _ptr(acc))
    BATCH_HIST.launches += 1
    return cand


def trim(counts, bsel: int, cm, room: int) -> int:
    """The accepted prefix (fused_train.py:1140-1153): candidate k joins
    while its count strictly beats the running max of the creation bounds
    cm[0 .. k-1]; at most ``room`` (M - i) merges."""
    bstar, bnd = 1, cm[0]
    for k in range(1, K_CAP):
        if k < bsel and bstar == k and counts[k] > bnd:
            bstar, bnd = k + 1, max(bnd, cm[k])
    return min(bstar, room)


def batch_apply_plain(ids, n, cand, slot, acc, ctl, log, M: int, ids_out,
                      live):
    """The trim over acc (acc_l, acc_r), then every site of a candidate
    below bstar becomes 256 + i + j in ids_out and its next token dies in
    live. Writes log rows i .. i + bstar - 1 with their kept counts, clears
    acc, and advances i by bstar."""
    if _gated_off(slot, 2, K_CAP):
        return
    _, zbase, rec = _slot_batch(slot)
    bsel, i = rec[SLOT_BSEL], rec[SLOT_I]
    cm = acc.view(2, HIST_BUCKETS, K_CAP).amax(dim=(0, 1)).tolist()
    bstar = trim(rec[SLOT_COUNT:SLOT_COUNT + K_CAP], bsel, cm, M - i)
    slot[SLOT_BSTAR] = bstar
    acc.zero_()
    ctl[CTL_I] = i + bstar
    nn = int(n.item())
    c = cand[:nn]
    keep = (c >= 0) & (c < bstar)
    ids_out[:nn] = torch.where(keep, zbase + c, ids[:nn])
    live[:nn] = True
    live[1:nn] = ~keep[:-1]
    kept = torch.bincount(c[keep].long(), minlength=K_CAP).tolist()
    for j in range(bstar):
        log[i + j] = torch.tensor(
            [rec[2 * j], rec[2 * j + 1], rec[SLOT_COUNT + j], kept[j]],
            dtype=torch.int32)


def batch_apply(ids, n, cand, slot, acc, ctl, log, M: int, ids_out, live,
                scratch=None):
    """One launch: the trim and the apply (batch_apply_plain). scratch:
    ``batch_scratch``'s, allocated per call where not given."""
    if not ids.is_cuda:
        return batch_apply_plain(ids, n, cand, slot, acc, ctl, log, M,
                                 ids_out, live)
    dev = ids.device
    cap = ids.numel()
    _check("ids", ids, torch.int32, dev, 0)
    _check("n", n, torch.int32, dev)
    _check("cand", cand, torch.int32, dev, cap)
    _check("acc", acc, torch.int32, dev, 2 * HIST_BUCKETS * K_CAP)
    _check_state(ctl, slot, log, dev)
    _check("ids_out", ids_out, torch.int32, dev, cap)
    _check("live", live, torch.bool, dev, cap)
    if acc.data_ptr() % 16:
        raise ValueError("acc: must be 16-byte aligned")
    if scratch is None:
        scratch = batch_scratch(dev)
    _check("scratch", scratch, torch.int32, dev, BATCH_SCRATCH)
    lib = _load()
    _run(dev, lib.bpe_batch_apply, _ptr(ids), _ptr(n), _ptr(cand),
         _ptr(slot), _ptr(acc), _ptr(ctl), _ptr(log), M, cap,
         _ptr(ids_out), _ptr(live), _ptr(scratch))
    BATCH_APPLY.launches += 1


# ---------------------------------------------------------------------------
# K4 compact
# ---------------------------------------------------------------------------

def compact_plain(ids, seg, live, n, slot=None):
    """(ids_out, seg_out, n_out): the live tokens of ids[:n], seg[:n] moved
    to the front in order; n_out is their count (int32[1]). With ``slot``,
    only when the slot applied a merge (bsel >= 1)."""
    if _gated_off(slot, 1, K_CAP):
        return ids.clone(), seg.clone(), n.clone()
    nn = int(n.item())
    keep = live[:nn]
    ids_out = torch.empty_like(ids)
    seg_out = torch.empty_like(seg)
    kept_ids = ids[:nn][keep]
    k = kept_ids.numel()
    ids_out[:k] = kept_ids
    seg_out[:k] = seg[:nn][keep]
    return ids_out, seg_out, torch.full_like(n, k)


def compact(ids, seg, live, n, slot=None):
    if not ids.is_cuda:
        return compact_plain(ids, seg, live, n, slot)
    dev = ids.device
    _check_stream(ids, seg, n)
    _check("live", live, torch.bool, dev, ids.numel())
    _check_state(slot=slot, device=dev)
    cap = ids.numel()
    ids_out = torch.empty_like(ids)
    seg_out = torch.empty_like(seg)
    n_out = torch.empty_like(n)
    lib = _load()
    state, gen = _lookback_state(dev, cap)
    _run(dev, lib.bpe_compact, _ptr(ids), _ptr(seg), _ptr(live), _ptr(n),
         _ptr(slot), cap, _ptr(ids_out), _ptr(seg_out), _ptr(n_out),
         _ptr(state), gen)
    COMPACT.launches += 1
    return ids_out, seg_out, n_out


# ---------------------------------------------------------------------------
# K9 pair_count (K1's counting core without first positions)
# ---------------------------------------------------------------------------

def pair_count_plain(ids, seg, n, V: int):
    """int32 (V, V): cnt[a, b] = the number of positions p with p + 1 < n,
    seg[p] == seg[p + 1] and (ids[p], ids[p + 1]) == (a, b), for a and b in
    [0, V); a pair with an id outside it counts nowhere."""
    VV = V * V
    nn = int(n.item())
    if nn < 2:
        return torch.zeros((V, V), dtype=torch.int32, device=ids.device)
    a, b = ids[:nn - 1].long(), ids[1:nn].long()
    ok = ((seg[:nn - 1] == seg[1:nn]) & (a >= 0) & (a < V) & (b >= 0)
          & (b < V))
    # pairs that do not count go to one extra bin, dropped at the end
    key = torch.where(ok, a * V + b, VV)
    return torch.bincount(key, minlength=VV + 1)[:VV].to(
        torch.int32).view(V, V)


def pair_count(ids, seg, n, V: int):
    if not ids.is_cuda:
        return pair_count_plain(ids, seg, n, V)
    dev = ids.device
    _check_stream(ids, seg, n)
    _check_width(V)
    cnt = torch.empty((V, V), dtype=torch.int32, device=dev)
    lib = _load()
    _run(dev, lib.bpe_pair_count, _ptr(ids), _ptr(seg), _ptr(n), _ptr(cnt),
         V, ids.numel(), 0, 0)
    PAIR_COUNT.launches += 1
    return cnt


# ---------------------------------------------------------------------------
# K10 encode_sweep
# ---------------------------------------------------------------------------

def encode_sweep_plain(ids, seg, pairs, new_ids):
    """(ids, seg, n): the merges of ``pairs`` (int32 (M, 2)) applied in rank
    order over the whole of ids, seg, merge r creating new_ids[r], each
    left first and followed by a compaction (K3's and K4's plain versions);
    n is an int32[1] tensor. A rank whose pair occurs nowhere changes
    nothing, so the loop goes from each applied rank straight to the next
    one whose pair is present (found by a search over the table's sorted
    pair keys)."""
    n = torch.full((1,), ids.numel(), dtype=torch.int32, device=ids.device)
    M = pairs.shape[0]
    if M == 0 or ids.numel() < 2:
        return ids, seg, n
    V = int(max(pairs.max(), ids.max(), new_ids.max())) + 1
    keys, order = torch.sort(pairs[:, 0].long() * V + pairs[:, 1].long(),
                             stable=True)
    r = 0
    while ids.numel() >= 2:
        k = ids[:-1].long() * V + ids[1:].long()
        at = torch.searchsorted(keys, k).clamp_(max=M - 1)
        rank = torch.where((keys[at] == k) & (seg[:-1] == seg[1:]),
                           order[at], M)
        rank = torch.where(rank >= r, rank, M)
        r = int(rank.min())
        if r >= M:
            break
        merged, live = merge_apply_plain(ids, seg, n, pairs[r],
                                         int(new_ids[r]))
        ids, seg, n = compact_plain(merged, seg, live, n)
        ids, seg = ids[:int(n)], seg[:int(n)]
        r += 1
    return ids, seg, n


def _sweep_buffers(dev, cap: int, grid: int, words: int):
    """Four 16-byte aligned rows (ids and seg, twice: the ping-pong), the
    ``words`` per block and n_out of a cooperative sweep."""
    row = max(-(-cap // 4) * 4, 4)
    return (torch.empty((4, row), dtype=torch.int32, device=dev),
            torch.empty(words * grid, dtype=torch.int32, device=dev),
            torch.empty(1, dtype=torch.int32, device=dev))


def _sweep_grid(lib, dev, cap: int) -> int:
    if cap > INT32_MAX - TILE:
        raise ValueError(f"encode_sweep: {cap} tokens; the kernel takes "
                         f"fewer than 2^31 - {TILE}")
    with torch.cuda.device(dev):
        grid = lib.bpe_encode_grid(cap)
    if grid < 1:
        raise RuntimeError(f"encode_sweep: no cooperative launch on {dev} "
                           f"(CUDA error {-grid})")
    return grid


def _check_rank_table(pairs, new_ids, dev):
    M = pairs.shape[0]
    _check("pairs", pairs, torch.int32, dev, 0)
    _check("new_ids", new_ids, torch.int32, dev, 0)
    if pairs.shape != (M, 2) or new_ids.shape != (M,):
        raise ValueError(f"pairs {tuple(pairs.shape)} and new_ids "
                         f"{tuple(new_ids.shape)}: expected (M, 2) and (M,)")


def encode_sweep(ids, seg, pairs, new_ids):
    """One launch for the whole sweep on the card. ``new_ids``: int32 (M,)
    on the stream's device. The result's ids and seg are views of one new
    allocation; the inputs are not written. Raises where the cooperative
    launch is refused."""
    if not ids.is_cuda:
        return encode_sweep_plain(ids, seg, pairs, new_ids)
    dev = ids.device
    cap = ids.numel()
    _check("ids", ids, torch.int32, dev, 0)
    _check("seg", seg, torch.int32, dev, cap)
    _check_rank_table(pairs, new_ids, dev)
    lib = _load()
    grid = _sweep_grid(lib, dev, cap)
    w, blk, n_out = _sweep_buffers(dev, cap, grid, 3)
    _run(dev, lib.bpe_encode_sweep, _ptr(ids), _ptr(seg), cap, _ptr(pairs),
         _ptr(new_ids), pairs.shape[0], _ptr(w[0]), _ptr(w[1]), _ptr(w[2]),
         _ptr(w[3]), _ptr(blk), grid, _ptr(n_out))
    ENCODE_SWEEP.launches += 1
    return w[0, :cap], w[1, :cap], n_out


# ---------------------------------------------------------------------------
# K11 chunk_encode, K12 encode_min_sweep: tables above the dense route's
# vocab, through the cuckoo pair table ``table`` (ops/ranktab.py
# CuckooPairTable: rows, H, seeds, and the rank-order pairs and new_ids)
# ---------------------------------------------------------------------------

def encode_min_sweep_plain(ids, seg, table, lows=None):
    """(ids, seg, n): every chunk (a run of equal seg) of the stream merges
    all occurrences of its own lowest-rank pair, left first, until it has
    none (minbpe/regex.py:96-108 per chunk; minbpe_tpu's _encode_flat,
    ops/flat_encode.py:61-186); n is an int32[1] tensor. Every chunk takes
    its own round at once. The loop of chunk_encode_plain, the plain version
    of K11 and K12. ``lows``: a list that takes each round's rank per chunk
    index (RANK_INF where the chunk applied none)."""
    ids, seg = ids.clone(), seg.clone()
    while ids.numel() >= 2:
        same = seg[:-1] == seg[1:]
        rank, nid = table.lookup(ids[:-1], torch.where(
            same, ids[1:], torch.full_like(ids[1:], -1)))
        if not bool((rank != RANK_INF).any()):
            break
        s = seg[:-1].long()
        low = torch.full((int(seg.max()) + 1,), RANK_INF, dtype=rank.dtype,
                         device=ids.device)
        low.scatter_reduce_(0, s, rank, "amin")
        if lows is not None:
            lows.append(low)
        m = (rank == low[s]) & (rank != RANK_INF)
        # consecutive matches are a run of one token (a, a): keep the even
        # offsets from the run's start
        pos = torch.arange(m.numel(), device=ids.device)
        prev = torch.zeros_like(m)
        prev[1:] = m[:-1]
        start = torch.where(m & ~prev, pos, torch.full_like(pos, -1))
        keep = m & ((pos - torch.cummax(start, 0).values) % 2 == 0)
        merged = ids.clone()
        merged[:-1] = torch.where(keep, nid, ids[:-1])
        live = torch.ones_like(seg, dtype=torch.bool)
        live[1:] = ~keep
        ids, seg = merged[live], seg[live]
    return ids, seg, torch.full((1,), ids.numel(), dtype=torch.int32,
                                device=ids.device)


def sweep_rounds(ids, seg, table):
    """(rounds of each chunk index of seg, distinct ranks applied anywhere)
    of encode_min_sweep_plain over the stream: a chunk's rounds are the
    distinct ranks it applies (its own sweep's length, what K12's
    ``rounds`` reports); a sweep whose rounds are global, one rank a round
    everywhere, takes as many rounds as all chunks' distinct ranks
    together."""
    lows = []
    encode_min_sweep_plain(ids, seg, table, lows)
    rounds = torch.zeros(int(seg.max()) + 1 if seg.numel() else 0,
                         dtype=torch.int64, device=ids.device)
    for low in lows:
        rounds += low != RANK_INF
    applied = [low[low != RANK_INF] for low in lows]
    union = int(torch.unique(torch.cat(applied)).numel()) if applied else 0
    return rounds, union


def place_chunks(ids, seg, n, bounds, out, lens):
    """Write a stream of whole chunks in order (ids[:n], seg[:n], seg the
    chunk index, n an int32[1] tensor) back at its chunks' input offsets:
    the k-th token of chunk c to out[bounds[c] + k], its count to lens[c].
    ``out`` and ``lens`` each have one more entry than they hold, where
    positions past n go. No host sync."""
    cap = ids.numel()
    if cap == 0:
        return
    q = torch.arange(cap, device=ids.device)
    valid = q < n.long()
    c = torch.where(valid, seg.long(), torch.zeros_like(q))
    first = valid.clone()
    first[1:] &= seg[1:] != seg[:-1]
    run = torch.cummax(torch.where(first, q, torch.zeros_like(q)), 0).values
    dest = torch.where(valid, bounds.long()[c] + q - run,
                       torch.full_like(q, out.numel() - 1))
    out.scatter_(0, dest, ids)
    lens.scatter_add_(0, torch.where(valid, c, torch.full_like(
        q, lens.numel() - 1)), valid.to(lens.dtype))


def chunk_encode_plain(ids, bounds, which, table, out, lens):
    """K11's and K12's function: each chunk c of ``which`` (chunk c is
    ids[bounds[c] .. bounds[c + 1]), of any length) encoded by
    encode_min_sweep_plain, its tokens written to out[bounds[c] ..] and
    their count to lens[c] (out and lens with one entry more than they
    hold, as place_chunks takes them)."""
    b = bounds.long()
    w = which.long()
    lo, L = b[w], b[w + 1] - b[w]
    k = torch.repeat_interleave(torch.arange(w.numel(), device=ids.device),
                                L)
    p = lo[k] + torch.arange(k.numel(), device=ids.device) - (
        torch.cumsum(L, 0) - L)[k]
    sub_ids, sub_seg, sub_n = encode_min_sweep_plain(
        ids[p], which[k].to(torch.int32), table)
    lens[w] = 0
    place_chunks(sub_ids, sub_seg, sub_n, bounds, out, lens)


def _cuckoo_args(table, dev):
    _check("rows", table.rows, torch.int32, dev, 8)
    _check_rank_table(table.pairs, table.new_ids, dev)
    if table.rows.shape != (2, table.H, 4) or table.H & (table.H - 1):
        raise ValueError(f"rows {tuple(table.rows.shape)}: expected (2, H, 4),"
                         " H a power of two")
    return (_ptr(table.rows), table.H, *table.seeds)


def chunk_encode(ids, bounds, which, table, out, lens, *, lanes):
    """One launch for the chunks of ``which`` (chunk_encode_plain), each of
    at most CHUNK_WARP_MAX tokens: ids, bounds (int32, C + 1 entries), which
    (int32), out and lens (int32) on one device. ``lanes``: the first
    ``lanes`` chunks of ``which`` go 32 to a warp, one a lane where it has
    at most K11_LANE_MAX tokens (the warp takes a longer one), and each
    later one has a warp of its own; ops/flat_encode.k11_order puts those
    of at most K11_LANE_MAX tokens first and counts them."""
    if not ids.is_cuda:
        return chunk_encode_plain(ids, bounds, which, table, out, lens)
    dev = ids.device
    _check("ids", ids, torch.int32, dev, 0)
    _check("bounds", bounds, torch.int32, dev, 1)
    _check("which", which, torch.int32, dev, 1)
    _check("out", out, torch.int32, dev, ids.numel())
    _check("lens", lens, torch.int32, dev, bounds.numel() - 1)
    S = which.numel()
    lanes = int(lanes)
    if not 0 <= lanes <= S:
        raise ValueError(f"lanes = {lanes} for {S} chunks")
    args = _cuckoo_args(table, dev)
    lib = _load()
    _run(dev, lib.bpe_chunk_encode, _ptr(ids), _ptr(bounds), _ptr(which), S,
         lanes, *args, _ptr(table.new_ids), _ptr(out), _ptr(lens))
    CHUNK_ENCODE.launches += 1


# K12's geometry (csrc/bpe_kernels.cu): threads a block, slots a thread in
# registers, the largest cluster, sub-ranges a thread in device memory
K12_TPB = 256
K12_P = 32
K12_CLUSTER_MAX = 16
K12_NS_MAX = 24
# the longest chunk one block holds in registers, and one cluster
K12_BLOCK_CAP = K12_TPB * K12_P
K12_ONCHIP_CAP = K12_CLUSTER_MAX * K12_BLOCK_CAP
# the cluster of a chunk in the device-memory tier, and its slots' groups
K12_DEVICE_CLUSTER = 16
K12_GROUP = 8
# the device tier's scratch offsets count units of this many ints (a slot
# is two ints; a chunk's scratch is whole groups of every thread's slots)
K12_BASE_UNIT = 2 * K12_TPB * K12_GROUP
# job modes: a block's own chunk, a cluster's in registers, a cluster's in
# device memory
K12_BLOCK, K12_CLUSTER, K12_DEVICE = 0, 1, 2


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _k12_device_slots(n: int) -> tuple[int, int]:
    """(P, S): a device-tier chunk of n tokens takes P slots a thread of a
    K12_DEVICE_CLUSTER cluster, in sub-ranges of S slots (whole groups, at
    most K12_NS_MAX a thread)."""
    P = -(-n // (K12_DEVICE_CLUSTER * K12_TPB))
    S = _round_up(max(K12_GROUP, -(-P // K12_NS_MAX)), K12_GROUP)
    return _round_up(P, S), S


def _k12_device_max() -> int:
    """The longest chunk whose slots the kernel's int32 positions reach."""
    lo, hi = K12_ONCHIP_CAP, INT32_MAX
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if K12_DEVICE_CLUSTER * K12_TPB * _k12_device_slots(mid)[0] \
                <= INT32_MAX:
            lo = mid
        else:
            hi = mid - 1
    return lo


K12_DEVICE_MAX = _k12_device_max()


def k12_plan(lengths):
    """K12's launch for chunks of these lengths (each above CHUNK_WARP_MAX,
    none above K12_DEVICE_MAX: ValueError): (jobs, cluster, ns, scratch
    ints, modes). A chunk of at most K12_BLOCK_CAP tokens is one block's,
    with the fewest of 8, 16 or K12_P slots a thread in registers that hold
    it; one of at most K12_ONCHIP_CAP a whole cluster's, 16 slots a thread
    (K12_P where the largest cluster needs them); a longer one a cluster's
    of K12_DEVICE_CLUSTER blocks, its slots in device memory. The launch's
    cluster is the least power of two every chunk fits; blocks that take a
    chunk alone are packed a cluster at a time. jobs: int32 (blocks, 4),
    one (w, mode | S << 4, P, base) a block, w the chunk's index in
    ``lengths`` (-1: idle), and for the device tier P slots a thread in
    sub-ranges of S, base their offset in the scratch in K12_BASE_UNIT
    ints; ns: the device tier's sub-ranges a thread."""
    lengths = [int(n) for n in lengths]
    if lengths and max(lengths) > K12_DEVICE_MAX:
        raise ValueError(f"a chunk of {max(lengths)} tokens: K12 takes at "
                         f"most {K12_DEVICE_MAX} tokens a chunk")
    need = 1
    for n in lengths:
        if n > K12_ONCHIP_CAP:
            need = max(need, K12_DEVICE_CLUSTER)
        elif n > K12_BLOCK_CAP:  # as many blocks as 16 slots a thread need
            blocks = -(-n // (16 * K12_TPB))
            need = max(need, min(K12_CLUSTER_MAX,
                                 1 << (blocks - 1).bit_length()))
    cs = need
    jobs, alone, modes = [], [], []
    ns, base = 1, 0
    for w, n in enumerate(lengths):
        if n <= K12_BLOCK_CAP:  # the fewest slots a thread that hold it
            P = next(p for p in (8, 16, K12_P) if n <= p * K12_TPB)
            alone.append((w, K12_BLOCK, P, 0))
            modes.append(K12_BLOCK)
        elif n <= cs * K12_BLOCK_CAP:  # 16 slots a thread where they hold it
            P = 16 if n <= cs * K12_TPB * 16 else K12_P
            jobs += [(w, K12_CLUSTER, P, 0)] * cs
            modes.append(K12_CLUSTER)
        else:
            P, S = _k12_device_slots(n)
            jobs += [(w, K12_DEVICE | S << 4, P, base // K12_BASE_UNIT)] * cs
            modes.append(K12_DEVICE)
            base += 2 * cs * K12_TPB * P
            ns = max(ns, P // S)
    alone += [(-1, 0, 0, 0)] * (-len(alone) % cs)
    return jobs + alone, cs, ns, base, modes


def encode_min_sweep(ids, bounds, which, table, out, lens, *, lengths,
                     rounds=None):
    """One launch for the chunks of ``which``, each longer than
    CHUNK_WARP_MAX tokens (chunk_encode_plain; on the card by k12_plan's
    jobs): ids, bounds (int32, C + 1 entries), which (int32), out and lens
    (int32) on one device, as chunk_encode takes them. ``lengths``: the
    chunks' lengths, on the host; ``rounds`` (int32, C entries, the card
    only): each chunk's rounds. Raises where the launch is refused."""
    if not ids.is_cuda:
        return chunk_encode_plain(ids, bounds, which, table, out, lens)
    dev = ids.device
    _check("ids", ids, torch.int32, dev, 0)
    _check("bounds", bounds, torch.int32, dev, 1)
    _check("which", which, torch.int32, dev, 1)
    _check("out", out, torch.int32, dev, ids.numel())
    _check("lens", lens, torch.int32, dev, bounds.numel() - 1)
    if rounds is not None:
        _check("rounds", rounds, torch.int32, dev, bounds.numel() - 1)
    args = _cuckoo_args(table, dev)
    if len(lengths) != which.numel():
        raise ValueError(f"{len(lengths)} lengths for {which.numel()} chunks")
    jobs, cs, ns, base, _ = k12_plan(lengths)
    jt = torch.tensor(jobs, dtype=torch.int32).to(dev)
    scratch = (torch.empty(base, dtype=torch.int32, device=dev) if base
               else None)
    lib = _load()
    _run(dev, lib.bpe_encode_min_sweep, _ptr(ids), _ptr(bounds),
         _ptr(which), _ptr(jt), len(jobs), cs, *args, _ptr(table.new_ids),
         _ptr(out), _ptr(lens), _ptr(rounds), _ptr(scratch), ns)
    ENCODE_MIN_SWEEP.launches += 1


# ---------------------------------------------------------------------------
# K17 segment_encode: a stream cut into many segments, through the table's
# cuckoo pairs (``table``: ops/ranktab.CuckooPairTable, of any size)
# ---------------------------------------------------------------------------

def segment_encode_plain(ids, seg, table):
    """(ids, seg, n): every segment of the stream (a maximal run of equal
    seg) encoded by its own lowest-rank loop (encode_min_sweep_plain over
    the runs), compacted in order, each token with its segment's seg; n is
    an int32[1] tensor. K10's output for K10's input."""
    cap = ids.numel()
    seg = seg[:cap]
    if cap == 0:
        return ids.clone(), seg.clone(), torch.zeros(1, dtype=torch.int32)
    first = torch.ones(cap, dtype=torch.bool, device=ids.device)
    first[1:] = seg[1:] != seg[:-1]
    run = (torch.cumsum(first, 0) - 1).to(torch.int32)
    out, out_run, n = encode_min_sweep_plain(ids, run, table)
    return out, seg[first][out_run.long()], n


def segment_encode(ids, seg, table):
    """One launch on the card: ids (int32) and seg (int32, at least as
    long) on one device, ``table`` the merges' CuckooPairTable there. The
    result's ids and seg are views of one new allocation; the inputs are
    not written."""
    if not ids.is_cuda:
        return segment_encode_plain(ids, seg, table)
    dev = ids.device
    cap = ids.numel()
    _check("ids", ids, torch.int32, dev, 0)
    _check("seg", seg, torch.int32, dev, cap)
    args = _cuckoo_args(table, dev)
    if cap > INT32_MAX - TILE:
        raise ValueError(f"segment_encode: {cap} tokens; the kernel takes "
                         f"at most 2^31 - 1 - {TILE}")
    w = torch.empty((3, max(cap, 1)), dtype=torch.int32, device=dev)
    if cap == 0:
        return w[0, :0], w[1, :0], torch.zeros(1, dtype=torch.int32,
                                                device=dev)
    n_out = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _load()
    state, gen = _lookback_state(dev, cap, SEGMENT_TILE)
    _run(dev, lib.bpe_segment_encode, _ptr(ids), _ptr(seg), cap, *args,
         _ptr(table.pairs), _ptr(table.new_ids), _ptr(w[2]), _ptr(w[0]),
         _ptr(w[1]), _ptr(n_out), _ptr(state), gen)
    SEGMENT_ENCODE.launches += 1
    return w[0, :cap], w[1, :cap], n_out


# ---------------------------------------------------------------------------
# K13 pair_select: the sort-round trainer's count and selection through a
# device hash table, one launch a round
# ---------------------------------------------------------------------------

EMPTY_FIRST = -1  # 0xFFFFFFFF as int32: no position yet


class PairTable:
    """K13's hash table for streams of up to ``n_tokens`` tokens on
    ``device``: ``capacity`` = 2^log2 >= 2 n_tokens slots of 16 bytes
    (``slots``, int32 (capacity, 4)), each a 64-bit key a << 32 | b (-1,
    all ones, when empty), a count and a first position (-1 when empty),
    also seen as the views ``key`` (int64), ``cnt`` and ``first``; ``list``
    holds the claimed slots' indices in its first ``used[0]`` entries.
    Distinct pairs never exceed n - 1, so the table is at most half full.
    Made empty, and left empty by every round. On the card it also holds
    K13's cooperative ``grid`` and the scratch of its blocks' bests.

    Plain versions: pair_table_plain writes the distinct pairs in key
    order into slots 0 .. D - 1 (any slots would do: selection goes by
    count and first position, which no two pairs share)."""

    BYTES_PER_SLOT = 20  # key 8, count 4, first 4, list 4

    @staticmethod
    def slots_log2(n_tokens: int) -> int:
        """log2 of the least power of two >= 2 n_tokens (at least 128)."""
        return max(7, (2 * max(int(n_tokens), 1) - 1).bit_length())

    def __init__(self, n_tokens: int, device, kernel: str = "pair_select"):
        """``kernel``: the cooperative kernel whose grid and scratch the
        table holds, "pair_select" (K13) or "pair_summaries" (K16)."""
        device = torch.device(device)
        self.log2 = self.slots_log2(n_tokens)
        if self.log2 > 30:
            raise ValueError(f"pair table: {n_tokens} tokens; it takes fewer "
                             "than 2^29")
        self.capacity = 1 << self.log2
        cap = self.capacity
        self.slots = torch.full((cap, 4), -1, dtype=torch.int32,
                                device=device)
        self.slots[:, 2] = 0
        self.key = self.slots.view(torch.int64)[:, 0]
        self.cnt = self.slots[:, 2]
        self.first = self.slots[:, 3]
        self.list = torch.zeros(cap, dtype=torch.int32, device=device)
        self.used = torch.zeros(1, dtype=torch.int32, device=device)
        self.grid = self.scratch = None
        if kernel not in ("pair_select", "pair_summaries"):
            raise ValueError(f"pair table: unknown kernel {kernel!r}")
        self.kernel = kernel
        if device.type == "cuda":
            with torch.cuda.device(device):
                self.grid = getattr(_load(), f"bpe_{kernel}_grid")()
            if self.grid < 1:
                raise RuntimeError(f"{kernel}: no cooperative launch on "
                                   f"{device} (CUDA error {-self.grid})")
            self.scratch = torch.zeros(2 * self.grid, dtype=torch.int64,
                                       device=device)

    @staticmethod
    def device_bytes(n_tokens: int) -> int:
        return PairTable.BYTES_PER_SLOT << PairTable.slots_log2(n_tokens)


def table_contents(table: PairTable):
    """(keys int64, counts int32, firsts int32) of the table's claimed
    slots, sorted by key."""
    s = table.list[:int(table.used)].long()
    keys, order = torch.sort(table.key[s])
    return keys, table.cnt[s][order], table.first[s][order]


def _gated(fail, i: int) -> bool:
    return fail is not None and int(fail) < i


def pair_table_plain(ids, seg, n, table: PairTable, fail=None, i: int = 0):
    """The count of K13 on an empty table: every countable pair of ids[:n]
    (p + 1 < n, seg[p] == seg[p + 1], both ids >= 0) with its count and
    its smallest position, claimed in key order. Nothing when fail (an
    int32[1] tensor) holds a round below i."""
    if _gated(fail, i):
        return
    if int(table.used):
        raise ValueError("pair_table_plain: the table is not empty")
    nn = int(n.item())
    if nn < 2:
        return
    a, b = ids[:nn - 1].long(), ids[1:nn].long()
    ok = (seg[:nn - 1] == seg[1:nn]) & (a >= 0) & (b >= 0)
    pos = torch.arange(nn - 1, device=ids.device)[ok]
    keys, inv, cnt = torch.unique((a[ok] << 32) | b[ok], sorted=True,
                                  return_inverse=True, return_counts=True)
    D = keys.numel()
    first = torch.full((D,), nn, dtype=torch.int64, device=ids.device)
    first.scatter_reduce_(0, inv, pos, "amin")
    table.key[:D] = keys
    table.cnt[:D] = cnt.to(torch.int32)
    table.first[:D] = first.to(torch.int32)
    table.list[:D] = torch.arange(D, dtype=torch.int32, device=ids.device)
    table.used[0] = D


def table_select_plain(table: PairTable, sel, pairs, counts, fail, i: int):
    """The selection of K13: the claimed slot with the largest count, then
    the earliest first position; sel = (pa, pb, count, 1) when there is one
    and fail >= i, else (-1, -1, 0, 0) and fail = min(fail, i). Writes log
    row i (pairs[i], counts[i]; zeros when not ok) and empties the table."""
    D = int(table.used)
    s = table.list[:D].long()
    c = table.cnt[s].long()
    f = table.first[s].long() & 0xFFFFFFFF
    k = table.key[s]
    table.key[s] = -1
    table.cnt[s] = 0
    table.first[s] = EMPTY_FIRST
    table.used.zero_()
    ok = D > 0 and int(fail) >= i
    if ok:
        j = int(torch.argmax((c << 32) | (0xFFFFFFFF - f)))
        pa, pb, cnt = int(k[j]) >> 32, int(k[j]) & 0xFFFFFFFF, int(c[j])
        rec = [pa, pb, cnt, 1]
    else:
        rec = [-1, -1, 0, 0]
        fail[0] = min(int(fail), i)
    sel.copy_(torch.tensor(rec, dtype=torch.int32))
    pairs[i] = torch.tensor(rec[:2] if ok else [0, 0], dtype=torch.int32)
    counts[i] = rec[2]


def pair_select_plain(ids, seg, n, table: PairTable, sel, pairs, counts,
                      fail, i: int):
    """K13's function: pair_table_plain, then table_select_plain."""
    pair_table_plain(ids, seg, n, table, fail, i)
    table_select_plain(table, sel, pairs, counts, fail, i)


def pair_select(ids, seg, n, table: PairTable, sel, pairs, counts, fail,
                i: int):
    """Round i of the sort-round trainer (pair_select_plain) in one
    cooperative launch: the stream (ids, seg, n) as K1 takes it, the empty
    ``table``, and sel int32[4], pairs int32 (M, 2), counts int32 (M,),
    fail int32[1], all on one device. Raises where the launch is
    refused."""
    if not ids.is_cuda:
        return pair_select_plain(ids, seg, n, table, sel, pairs, counts,
                                 fail, i)
    dev = ids.device
    M = counts.numel()
    _check_stream(ids, seg, n)
    _check("slots", table.slots, torch.int32, dev, 4 * table.capacity)
    _check("list", table.list, torch.int32, dev, table.capacity)
    _check("used", table.used, torch.int32, dev)
    _check("sel", sel, torch.int32, dev, 4)
    _check("pairs", pairs, torch.int32, dev, 2 * M)
    _check("counts", counts, torch.int32, dev, M)
    _check("fail", fail, torch.int32, dev)
    if not 0 <= i < M:
        raise ValueError(f"pair_select: round {i} outside 0 .. {M - 1}")
    if table.capacity < 2 * ids.numel():
        raise ValueError(f"pair_select: {ids.numel()} tokens need at least "
                         f"{2 * ids.numel()} slots, the table has "
                         f"{table.capacity}")
    _check("scratch", table.scratch, torch.int64, dev, 2 * table.grid)
    lib = _load()
    _run(dev, lib.bpe_pair_select, _ptr(ids), _ptr(seg), _ptr(n), _ptr(fail),
         i, _ptr(table.slots), _ptr(table.list), _ptr(table.used), table.log2,
         _ptr(sel), _ptr(pairs), _ptr(counts), _ptr(table.scratch),
         table.grid)
    PAIR_SELECT.launches += 1


# ---------------------------------------------------------------------------
# K16 pair_summaries: the distributed trainer's sparse and owner selections
# on K13's table (kernel="pair_summaries"), one launch per count or merge
# ---------------------------------------------------------------------------

NO_CHAMPION = (-1, -1, 0, INT32_MAX)


def _table_args(table: PairTable, dev):
    if table.kernel != "pair_summaries":
        raise ValueError("pair_summaries: the table holds K13's grid; make "
                         "it with kernel='pair_summaries'")
    _check("slots", table.slots, torch.int32, dev, 4 * table.capacity)
    _check("list", table.list, torch.int32, dev, table.capacity)
    _check("used", table.used, torch.int32, dev)
    _check("scratch", table.scratch, torch.int64, dev, 2 * table.grid)
    return (_ptr(table.slots), _ptr(table.list), _ptr(table.used),
            table.log2)


def _check_rows(name, rows, dev, n_rows):
    _check(name, rows, torch.int32, dev, 4 * n_rows)
    if rows.dim() != 2 or rows.shape[1] != 4:
        raise ValueError(f"{name}: must be (rows, 4)")
    if rows.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def pair_summaries_plain(ids, seg, n, table: PairTable, base: int, out,
                         used, overflow):
    """The count of K16: the distinct countable pairs of ids[:n] (p + 1 <
    n, seg[p] == seg[p + 1], both ids >= 0) as rows (a, b, count, first +
    base) of out (int32 (K, 4)), the first K of them in key order;
    used[0] = the rows written; overflow[0] = 1 where there are more than
    K (it is never cleared). The table is not touched."""
    K = out.shape[0]
    nn = int(n.item())
    D = 0
    if nn >= 2:
        a, b = ids[:nn - 1].long(), ids[1:nn].long()
        ok = (seg[:nn - 1] == seg[1:nn]) & (a >= 0) & (b >= 0)
        pos = torch.arange(nn - 1, device=ids.device)[ok]
        keys, inv, cnt = torch.unique((a[ok] << 32) | b[ok], sorted=True,
                                      return_inverse=True,
                                      return_counts=True)
        D = keys.numel()
        first = torch.full((D,), nn, dtype=torch.int64, device=ids.device)
        first.scatter_reduce_(0, inv, pos, "amin")
        w = min(D, K)
        out[:w] = torch.stack([keys[:w] >> 32, keys[:w] & 0xFFFFFFFF,
                               cnt[:w], first[:w] + base], 1).to(torch.int32)
    used[0] = min(D, K)
    if D > K:
        overflow[0] = 1


def pair_summaries(ids, seg, n, table: PairTable, base: int, out, used,
                   overflow):
    """The count of K16 on the card (pair_summaries_plain; the rows in the
    table's list order, which the merge does not depend on), in one
    cooperative launch that leaves the table empty. Raises where the launch
    is refused."""
    if not ids.is_cuda:
        return pair_summaries_plain(ids, seg, n, table, base, out, used,
                                    overflow)
    dev = ids.device
    _check_stream(ids, seg, n)
    _check_rows("out", out, dev, 1)
    _check("used", used, torch.int32, dev)
    _check("overflow", overflow, torch.int32, dev)
    if table.capacity < 2 * ids.numel():
        raise ValueError(f"pair_summaries: {ids.numel()} tokens need at "
                         f"least {2 * ids.numel()} slots, the table has "
                         f"{table.capacity}")
    if not 0 <= base <= INT32_MAX - ids.numel():
        raise ValueError(f"pair_summaries: base {base} puts positions past "
                         "2^31")
    slots, lst, tused, log2 = _table_args(table, dev)
    lib = _load()
    _run(dev, lib.bpe_pair_summaries, _ptr(ids), _ptr(seg), _ptr(n), base,
         slots, lst, tused, log2, _ptr(out), out.shape[0], _ptr(used),
         _ptr(overflow), _ptr(table.scratch), table.grid)
    PAIR_SUMMARIES.launches += 1


def pair_summaries_merge_plain(rows, lens, table: PairTable, champ):
    """The merge of K16: rows (int32 (nb * bs, 4)) in nb = lens.numel()
    blocks of bs, the first lens[j] of block j valid, merged by pair
    (counts add, firsts take the minimum); champ = the pair with the
    largest count, and among equal counts the earliest first, as (a, b,
    count, first), or NO_CHAMPION when no row is valid."""
    nb = lens.numel()
    bs = rows.shape[0] // nb
    r = torch.arange(bs, device=rows.device)
    valid = (r[None, :] < lens.long()[:, None]).reshape(-1)
    v = rows[:nb * bs][valid].long()
    if v.shape[0] == 0:
        champ.copy_(torch.tensor(NO_CHAMPION, dtype=torch.int32))
        return
    keys, inv = torch.unique((v[:, 0] << 32) | v[:, 1], return_inverse=True)
    cnt = torch.zeros(keys.numel(), dtype=torch.int64, device=rows.device)
    cnt.scatter_add_(0, inv, v[:, 2])
    first = torch.full((keys.numel(),), INT32_MAX, dtype=torch.int64,
                       device=rows.device)
    first.scatter_reduce_(0, inv, v[:, 3], "amin")
    j = int(torch.argmax((cnt << 32) | (0xFFFFFFFF - first)))
    k = int(keys[j])
    champ.copy_(torch.tensor([k >> 32, k & 0xFFFFFFFF, int(cnt[j]),
                              int(first[j])], dtype=torch.int32))


def pair_summaries_merge(rows, lens, table: PairTable, champ):
    """The merge of K16 on the card (pair_summaries_merge_plain), one
    cooperative launch that leaves the table empty."""
    if not rows.is_cuda:
        return pair_summaries_merge_plain(rows, lens, table, champ)
    dev = rows.device
    _check("lens", lens, torch.int32, dev)
    nb = lens.numel()
    bs = rows.shape[0] // nb
    _check_rows("rows", rows, dev, nb * bs)
    _check("champ", champ, torch.int32, dev, 4)
    if table.capacity < 2 * nb * bs:
        raise ValueError(f"pair_summaries_merge: {nb * bs} rows need at "
                         f"least {2 * nb * bs} slots, the table has "
                         f"{table.capacity}")
    slots, lst, tused, log2 = _table_args(table, dev)
    lib = _load()
    _run(dev, lib.bpe_pair_summaries_merge, _ptr(rows), _ptr(lens), nb, bs,
         slots, lst, tused, log2, _ptr(champ), _ptr(table.scratch),
         table.grid)
    PAIR_SUMMARIES.launches += 1
