"""The CUDA kernels of the main path, their build, bindings and plain twins.

Twelve kernels (csrc/bpe_kernels.cu) carry training and encode over a dense
token stream (ids, seg) whose live length n is an int32[1] tensor on the
same device, so a whole run launches without a host sync per merge:

- ``pair_stats``     K1: exact pair counts and first positions (V x V);
- ``select_batch``   K5: the selection walk of one count rebuild: up to
  K_CAP candidates in the reference's order, stopped at the first one that
  cannot join the batch;
- ``merge_apply``    K3: apply one merge everywhere, left first;
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
  (a cuckoo pair table, ops/ranktab.py), one warp per chunk of at most
  CHUNK_MAX tokens;
- ``encode_min_sweep`` K12: the same for a stream of longer chunks: K10's
  sweep, each round applying the lowest rank present, in one cooperative
  launch.
- ``pair_table``     K13: the sort-round trainer's count: every pair's
  count and first position into a device hash table (``PairTable``);
- ``table_select``   K14: that round's selection from the table's claimed
  slots, which it leaves empty, and the round's record.

K1, K9 and K13 share one counting core: each block of a persistent grid
counts one contiguous range of the stream into a hash table of pairs in
shared memory and adds it into the matrices with one global atomic per
distinct pair (K1 also a min of first positions), or (K13) into a hash
table in device memory with one insert per distinct pair.

K6 walks the live tiles of the stream with a persistent grid and keeps
each block's histograms in shared memory; the trainer makes its ``cand``
once per run.

K5, K8 and K14 each hand their blocks' partial results to the last block
to finish through a done counter in a scratch tensor that the trainer
makes once per run (``select_scratch``, ``batch_scratch``, the
``PairTable``'s); that block leaves it zero again, so no launch clears it
first.

K3 and K4 chain their tiles with a decoupled look-back over status words
that persist per stream (``_lookback_state``); each call tags them with a
new generation, so no call clears them first.

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
INT32_MAX = 2**31 - 1
# the longest chunk K11 takes (CHUNK_MAX on the card)
CHUNK_WARP_MAX = 256
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
PAIR_TABLE = KernelInfo(
    "pair_table",
    "minbpe_tpu/ops/train_sortloop.py:49 (_round, a jitted lax.fori_loop "
    "body; no Pallas site): its stable lax.sort of (a, b, position) and run "
    "scans, :62-76")
TABLE_SELECT = KernelInfo(
    "table_select",
    "minbpe_tpu/ops/train_sortloop.py:49 (_round; no Pallas site): its "
    "selection, :70-78 (largest count, then earliest first occurrence)")
KERNELS = (PAIR_STATS, SELECT_BATCH, MERGE_APPLY, BATCH_HIST, BATCH_APPLY,
           COMPACT, PAIR_COUNT, ENCODE_SWEEP, CHUNK_ENCODE, ENCODE_MIN_SWEEP,
           PAIR_TABLE, TABLE_SELECT)


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
    "bpe_select_blocks": [_I],
    "bpe_pair_stats": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bpe_select_batch": [_P, _P, _I, _P, _P, _P, _P, _P],
    "bpe_merge_apply": [_P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P],
    "bpe_batch_hist": [_P, _P, _P, _P, _I, _P, _P, _P],
    "bpe_batch_apply": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "bpe_compact": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P],
    "bpe_encode_grid": [_I, _I],
    "bpe_encode_sweep": [_P, _P, _I, _P, _P, _I, _P,
                         _P, _P, _P, _P, _I, _P, _P],
    "bpe_chunk_encode": [_P, _P, _P, _I, _P, _I, _U, _U, _U, _U, _P, _P, _P,
                         _P],
    "bpe_encode_min_sweep": [_P, _P, _I, _P, _I, _U, _U, _U, _U, _P, _P,
                             _P, _P, _P, _P, _P, _I, _P, _P],
    "bpe_pair_count": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bpe_pair_hist_grid": [_I, _I, _I],
    "bpe_pair_table": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _P],
    "bpe_table_select_grid": [],
    "bpe_table_select": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P,
                         _P],
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
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        if lib.bpe_tile_size() != TILE:
            raise RuntimeError(f"the kernels' tile is {lib.bpe_tile_size()} "
                               f"positions, kernels.TILE {TILE}")
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


def _tiles(cap: int) -> int:
    return max(1, -(-cap // TILE))


# K3's and K4's look-back state, per (device, stream): [tensor, last
# generation]
_LOOKBACK: dict = {}
_LOOKBACK_LOCK = threading.Lock()
_GEN_MAX = (1 << 30) - 1


def _lookback_state(device, cap: int):
    """(state, gen) for one K3 or K4 launch over cap positions on
    ``device``'s current stream: state is int64[1 + tiles], word 0 the tile
    counter (each launch leaves it 0), then a status word per tile, zeroed
    once when it is allocated or grown; gen is this call's generation
    (1 .. 2^30 - 1), which tells the launch's status words from those left
    by earlier ones. Each stream has its own state, and launches on one
    stream run in order, so no two launches in flight share it."""
    tiles = _tiles(cap)
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
                      slot=None, log=None):
    """(ids_out, live): pair (pair[0], pair[1]) -> z at every occurrence in
    ids[:n], left first; live[i] is False for the token consumed by a kept
    match. Adds the kept count to kept[0] when given. With ``slot`` (the
    trainer): only when bsel == 1, the pair is the slot's candidate 0, z its
    256 + i, and the kept count goes to log row i."""
    ids_out = ids.clone()
    live = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    if _gated_off(slot, 1, 1):
        return ids_out, live
    if slot is not None:
        pair, z = slot[:2], int(slot[SLOT_ZBASE])
        kept = log[int(slot[SLOT_I]), 3:4]
    nn = int(n.item())
    if nn < 2:
        return ids_out, live
    pa, pb = int(pair[0]), int(pair[1])
    x = ids[:nn]
    m = torch.zeros(nn, dtype=torch.bool, device=ids.device)
    m[:-1] = (x[:-1] == pa) & (x[1:] == pb) & (seg[:nn - 1] == seg[1:nn])
    prev = torch.zeros_like(m)
    prev[1:] = m[:-1]
    pos = torch.arange(nn, device=ids.device)
    start = torch.where(m & ~prev, pos, torch.full_like(pos, -1))
    run_start = torch.cummax(start, 0).values
    keep = m & ((pos - run_start) % 2 == 0)
    ids_out[:nn] = torch.where(keep, torch.full_like(x, z), x)
    live[1:nn] = ~keep[:-1]
    if kept is not None:
        kept += keep.sum().to(kept.dtype)
    return ids_out, live


def merge_apply(ids, seg, n, pair=None, z: int = 0, kept=None, *, slot=None,
                log=None):
    if not ids.is_cuda:
        return merge_apply_plain(ids, seg, n, pair, z, kept, slot=slot,
                                 log=log)
    dev = ids.device
    _check_stream(ids, seg, n)
    if slot is not None:
        _check_state(slot=slot, log=log, device=dev)
        pair, kept = slot, log
    _check("pair", pair, torch.int32, dev, 2)
    if kept is not None:
        _check("kept", kept, torch.int32, dev)
    cap = ids.numel()
    ids_out = torch.empty_like(ids)
    live = torch.empty(cap, dtype=torch.bool, device=dev)
    lib = _load()
    state, gen = _lookback_state(dev, cap)
    _run(dev, lib.bpe_merge_apply, _ptr(ids), _ptr(seg), _ptr(n),
         _ptr(pair), z, _ptr(slot), cap, _ptr(ids_out), _ptr(live),
         _ptr(kept), _ptr(state), gen)
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


def _sweep_grid(lib, dev, cap: int, min_sweep: bool, name: str) -> int:
    if cap > INT32_MAX - TILE:
        raise ValueError(f"{name}: {cap} tokens; the kernel takes fewer "
                         f"than 2^31 - {TILE}")
    with torch.cuda.device(dev):
        grid = lib.bpe_encode_grid(cap, int(min_sweep))
    if grid < 1:
        raise RuntimeError(f"{name}: no cooperative launch on {dev} "
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
    grid = _sweep_grid(lib, dev, cap, False, "encode_sweep")
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

def encode_min_sweep_plain(ids, seg, table):
    """(ids, seg, n): every chunk (a run of equal seg) of the stream merges
    all occurrences of its own lowest-rank pair, left first, until it has
    none (minbpe/regex.py:96-108 per chunk; minbpe_tpu's _encode_flat,
    ops/flat_encode.py:61-186); n is an int32[1] tensor. The plain version
    of K11 and K12: chunks are independent and the ranks a chunk applies
    only rise, so K12's rule (the grid's lowest rank, applied everywhere)
    gives the same stream."""
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
    """K11's function: each chunk c of ``which`` (chunk c is ids[bounds[c]
    .. bounds[c + 1])) encoded by encode_min_sweep_plain, its tokens
    written to out[bounds[c] ..] and their count to lens[c] (out and lens
    with one entry more than they hold, as place_chunks takes them)."""
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


def chunk_encode(ids, bounds, which, table, out, lens):
    """One launch for the chunks of ``which`` (chunk_encode_plain), each of
    at most CHUNK_WARP_MAX tokens: ids, bounds (int32, C + 1 entries), which
    (int32), out and lens (int32) on one device."""
    if not ids.is_cuda:
        return chunk_encode_plain(ids, bounds, which, table, out, lens)
    dev = ids.device
    _check("ids", ids, torch.int32, dev, 0)
    _check("bounds", bounds, torch.int32, dev, 1)
    _check("which", which, torch.int32, dev, 1)
    _check("out", out, torch.int32, dev, ids.numel())
    _check("lens", lens, torch.int32, dev, bounds.numel() - 1)
    args = _cuckoo_args(table, dev)
    lib = _load()
    _run(dev, lib.bpe_chunk_encode, _ptr(ids), _ptr(bounds), _ptr(which),
         which.numel(), *args, _ptr(table.new_ids), _ptr(out), _ptr(lens))
    CHUNK_ENCODE.launches += 1


def encode_min_sweep(ids, seg, table):
    """One cooperative launch for the whole stream (encode_min_sweep_plain).
    The result's ids and seg are views of one new allocation; the inputs
    are not written. Raises where the cooperative launch is refused."""
    if not ids.is_cuda:
        return encode_min_sweep_plain(ids, seg, table)
    dev = ids.device
    cap = ids.numel()
    _check("ids", ids, torch.int32, dev, 0)
    _check("seg", seg, torch.int32, dev, cap)
    args = _cuckoo_args(table, dev)
    lib = _load()
    grid = _sweep_grid(lib, dev, cap, True, "encode_min_sweep")
    w, blk, n_out = _sweep_buffers(dev, cap, grid, 4)
    _run(dev, lib.bpe_encode_min_sweep, _ptr(ids), _ptr(seg), cap, *args,
         _ptr(table.pairs), _ptr(table.new_ids), _ptr(w[0]), _ptr(w[1]),
         _ptr(w[2]), _ptr(w[3]), _ptr(blk), grid, _ptr(n_out))
    ENCODE_MIN_SWEEP.launches += 1
    return w[0, :cap], w[1, :cap], n_out


# ---------------------------------------------------------------------------
# K13 pair_table, K14 table_select: the sort-round trainer's count and
# selection through a device hash table
# ---------------------------------------------------------------------------

EMPTY_FIRST = -1  # 0xFFFFFFFF as int32: no position yet


class PairTable:
    """K13's hash table for streams of up to ``n_tokens`` tokens on
    ``device``: ``capacity`` = 2^log2 >= 2 n_tokens slots, each a 64-bit
    key a << 32 | b (-1, all ones, when empty), a count and a first
    position (-1 when empty); ``list`` holds the claimed slots' indices in
    its first ``used[0]`` entries. Distinct pairs never exceed n - 1, so
    the table is at most half full. Made empty, and left empty by every
    table_select. On the card it also holds K14's scratch.

    Plain versions: pair_table_plain writes the distinct pairs in key
    order into slots 0 .. D - 1 (any slots would do: selection goes by
    count and first position, which no two pairs share)."""

    BYTES_PER_SLOT = 20  # key 8, count 4, first 4, list 4

    @staticmethod
    def slots_log2(n_tokens: int) -> int:
        """log2 of the least power of two >= 2 n_tokens (at least 128)."""
        return max(7, (2 * max(int(n_tokens), 1) - 1).bit_length())

    def __init__(self, n_tokens: int, device):
        device = torch.device(device)
        self.log2 = self.slots_log2(n_tokens)
        if self.log2 > 30:
            raise ValueError(f"pair table: {n_tokens} tokens; it takes fewer "
                             "than 2^29")
        self.capacity = 1 << self.log2
        cap = self.capacity
        self.key = torch.full((cap,), -1, dtype=torch.int64, device=device)
        self.cnt = torch.zeros(cap, dtype=torch.int32, device=device)
        self.first = torch.full((cap,), EMPTY_FIRST, dtype=torch.int32,
                                device=device)
        self.list = torch.zeros(cap, dtype=torch.int32, device=device)
        self.used = torch.zeros(1, dtype=torch.int32, device=device)
        self.scratch = None
        if device.type == "cuda":
            grid = _load().bpe_table_select_grid()
            self.scratch = torch.zeros(1 + 2 * grid, dtype=torch.int64,
                                       device=device)

    @staticmethod
    def device_bytes(n_tokens: int) -> int:
        return PairTable.BYTES_PER_SLOT << PairTable.slots_log2(n_tokens)

    def _tensors(self):
        return (self.key, self.cnt, self.first, self.list, self.used)


def table_contents(table: PairTable):
    """(keys int64, counts int32, firsts int32) of the table's claimed
    slots, sorted by key."""
    s = table.list[:int(table.used)].long()
    keys, order = torch.sort(table.key[s])
    return keys, table.cnt[s][order], table.first[s][order]


def _gated(fail, i: int) -> bool:
    return fail is not None and int(fail) < i


def pair_table_plain(ids, seg, n, table: PairTable, fail=None, i: int = 0):
    """K13's function on an empty table: every countable pair of ids[:n]
    (p + 1 < n, seg[p] == seg[p + 1], both ids >= 0) with its count and
    its smallest position, claimed in key order. Nothing when fail (an
    int32[1] tensor) holds a round below i."""
    if _gated(fail, i):
        return
    if int(table.used):
        raise ValueError("pair_table: the table is not empty")
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


def pair_table(ids, seg, n, table: PairTable, fail=None, i: int = 0):
    """Count every pair of the stream into ``table`` (pair_table_plain);
    ``fail`` (int32[1], may be None) and ``i`` gate it off after a failed
    round."""
    if not ids.is_cuda:
        return pair_table_plain(ids, seg, n, table, fail, i)
    dev = ids.device
    _check_stream(ids, seg, n)
    if fail is not None:
        _check("fail", fail, torch.int32, dev)
    for name, t, dt in zip(("key", "cnt", "first", "list", "used"),
                           table._tensors(), (torch.int64, torch.int32,
                                              torch.int32, torch.int32,
                                              torch.int32)):
        _check(name, t, dt, dev)
    if table.capacity < 2 * ids.numel():
        raise ValueError(f"pair_table: {ids.numel()} tokens need at least "
                         f"{2 * ids.numel()} slots, the table has "
                         f"{table.capacity}")
    lib = _load()
    _run(dev, lib.bpe_pair_table, _ptr(ids), _ptr(seg), _ptr(n), _ptr(fail),
         i, *(_ptr(t) for t in table._tensors()), table.log2, ids.numel(),
         0, 0)
    PAIR_TABLE.launches += 1


def table_select_plain(table: PairTable, sel, pairs, counts, fail, i: int):
    """K14's function: the claimed slot with the largest count, then the
    earliest first position; sel = (pa, pb, count, 1) when there is one and
    fail >= i, else (-1, -1, 0, 0) and fail = min(fail, i). Writes log row
    i (pairs[i], counts[i]; zeros when not ok) and empties the table."""
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


def table_select(table: PairTable, sel, pairs, counts, fail, i: int):
    """One launch (table_select_plain): sel int32[4], pairs int32 (M, 2),
    counts int32 (M,), fail int32[1], all on the table's device."""
    dev = table.key.device
    if dev.type != "cuda":
        return table_select_plain(table, sel, pairs, counts, fail, i)
    M = counts.numel()
    _check("sel", sel, torch.int32, dev, 4)
    _check("pairs", pairs, torch.int32, dev, 2 * M)
    _check("counts", counts, torch.int32, dev, M)
    _check("fail", fail, torch.int32, dev)
    if not 0 <= i < M:
        raise ValueError(f"table_select: round {i} outside 0 .. {M - 1}")
    lib = _load()
    _check("scratch", table.scratch, torch.int64, dev,
           1 + 2 * lib.bpe_table_select_grid())
    _run(dev, lib.bpe_table_select, *(_ptr(t) for t in table._tensors()),
         table.log2, _ptr(sel), _ptr(pairs), _ptr(counts), _ptr(fail), i,
         _ptr(table.scratch))
    TABLE_SELECT.launches += 1
