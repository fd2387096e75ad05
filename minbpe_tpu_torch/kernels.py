"""The CUDA kernels of the main path, their build, bindings and plain twins.

Eight kernels (csrc/bpe_kernels.cu) carry training and encode over a dense
token stream (ids, seg) whose live length n is an int32[1] tensor on the
same device, so a whole run launches without a host sync per merge:

- ``pair_stats``     K1: exact pair counts and first positions (V x V);
- ``select_batch``   K5: the selection walk of one count rebuild: up to
  K_CAP candidates in the reference's order, stopped at the first one that
  cannot join the batch;
- ``merge_apply``    K3: apply one merge everywhere, left first;
- ``batch_mark``     K6: the batch's sites, final ids and left-creation
  histogram;
- ``batch_hist_rev`` K7: the right-creation histogram;
- ``batch_apply``    K8: the trim, then the batch's combined apply;
- ``compact``        K4: order-preserving compaction by the live mask;
- ``pair_count``     K9: the dense V x V pair-count matrix of the selection
  paths and the stepped trainer's first count.

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

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "bpe_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

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
    "(_apply_kernel); minbpe_tpu/ops/pallas/fused_encode.py:45 (_kernel: "
    "per-rank body :58-87)")
BATCH_MARK = KernelInfo(
    "batch_mark",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: tiled_batch_mark "
    ":452-521); minbpe_tpu/ops/pallas/fused_train_xl.py:328 (_mark_kernel)")
BATCH_HIST_REV = KernelInfo(
    "batch_hist_rev",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: "
    "tiled_batch_hist_rev :524-593); minbpe_tpu/ops/pallas/"
    "fused_train_xl.py:392 (_histrev_kernel)")
BATCH_APPLY = KernelInfo(
    "batch_apply",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: trim :1140-1153, "
    "tiled_batch_apply :596-634); minbpe_tpu/ops/pallas/fused_train_xl.py"
    ":442 (_batch_apply_kernel)")
COMPACT = KernelInfo(
    "compact",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: _compact_inplace "
    ":641-736); minbpe_tpu/ops/pallas/fused_train_xl.py:300 "
    "(_compact_kernel); minbpe_tpu/ops/pallas/fused_encode.py:45 (_kernel: "
    "output compaction :91-119)")
PAIR_COUNT = KernelInfo(
    "pair_count",
    "minbpe_tpu/ops/pallas/pair_count.py:29 (_kernel, launched by "
    "count_pairs_pallas :56-90)")
KERNELS = (PAIR_STATS, SELECT_BATCH, MERGE_APPLY, BATCH_MARK, BATCH_HIST_REV,
           BATCH_APPLY, COMPACT, PAIR_COUNT)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

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
        P, I = ctypes.c_void_p, ctypes.c_int
        sigs = {
            "bpe_tile_size": [],
            "bpe_select_blocks": [I],
            "bpe_pair_stats": [P, P, P, P, P, P, I, I, P],
            "bpe_select_batch": [P, P, I, P, P, P, P, P, P],
            "bpe_merge_apply": [P, P, P, P, I, P, I, P, P, P, P, P],
            "bpe_batch_mark": [P, P, P, P, I, P, P, P, P],
            "bpe_batch_hist_rev": [P, P, P, P, P, P, I, P, P],
            "bpe_batch_apply": [P, P, P, P, P, P, P, I, I, P, P, P],
            "bpe_compact": [P, P, P, P, P, I, P, P, P, P, P],
            "bpe_pair_count": [P, P, P, P, I, I, P],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
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
    tile = _load().bpe_tile_size()
    return max(1, -(-cap // tile))


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


def select_scratch(V: int, device) -> torch.Tensor:
    """K5's scratch (a done counter and each block's top keys), zero."""
    if device.type != "cuda":
        return None
    blocks = _load().bpe_select_blocks(V)
    return torch.zeros(1 + blocks * K_CAP, dtype=torch.int64, device=device)


def _idle(ctl) -> bool:
    return ctl is not None and int(ctl[CTL_I]) >= int(ctl[CTL_FAIL])


def _gated_off(slot, lo: int, hi: int) -> bool:
    return slot is not None and not lo <= int(slot[SLOT_BSEL]) <= hi


# ---------------------------------------------------------------------------
# K1 pair_stats
# ---------------------------------------------------------------------------

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
    cnt, first = _stats_out(V, dev, out)
    _check("cnt", cnt, torch.int32, dev, V * V)
    _check("first", first, torch.int32, dev, V * V)
    lib = _load()
    _run(dev, lib.bpe_pair_stats, _ptr(ids), _ptr(seg), _ptr(n), _ptr(ctl),
         _ptr(cnt), _ptr(first), V, ids.numel())
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
    lib = _load()
    _check("scratch", scratch, torch.int64, dev,
           1 + lib.bpe_select_blocks(V) * K_CAP)
    _run(dev, lib.bpe_select_batch, _ptr(cnt), _ptr(first), V, _ptr(ids),
         _ptr(ctl), _ptr(slot), _ptr(log), _ptr(scratch))
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
    agg = torch.empty(_tiles(cap), dtype=torch.int32, device=dev)
    lib = _load()
    _run(dev, lib.bpe_merge_apply, _ptr(ids), _ptr(seg), _ptr(n),
         _ptr(pair), z, _ptr(slot), cap, _ptr(ids_out), _ptr(live),
         _ptr(kept), _ptr(agg))
    MERGE_APPLY.launches += 1
    return ids_out, live


# ---------------------------------------------------------------------------
# K6 batch_mark, K7 batch_hist_rev, K8 batch_apply (bsel >= 2)
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
    ids[p-1] & 127 too when p-1 lies in a site."""
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


def batch_mark(ids, seg, n, slot, acc_l):
    if not ids.is_cuda:
        return batch_mark_plain(ids, seg, n, slot, acc_l)
    dev = ids.device
    _check_stream(ids, seg, n)
    _check_state(slot=slot, device=dev)
    _check("acc_l", acc_l, torch.int32, dev, HIST_BUCKETS * K_CAP)
    cap = ids.numel()
    cand = torch.empty_like(ids)
    F = torch.empty_like(ids)
    lib = _load()
    _run(dev, lib.bpe_batch_mark, _ptr(ids), _ptr(seg), _ptr(n), _ptr(slot),
         cap, _ptr(cand), _ptr(F), _ptr(acc_l))
    BATCH_MARK.launches += 1
    return cand, F


def batch_hist_rev_plain(ids, seg, n, cand, F, slot, acc_r):
    """Adds the right-creation histogram to acc_r (128, K_CAP): per site p
    of j whose second-next token p+2 is in its chunk, row F[p+2] & 127, and
    row ids[p+2] & 127 too when p+2 lies in a site."""
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


def batch_hist_rev(ids, seg, n, cand, F, slot, acc_r):
    if not ids.is_cuda:
        return batch_hist_rev_plain(ids, seg, n, cand, F, slot, acc_r)
    dev = ids.device
    _check_stream(ids, seg, n)
    _check("cand", cand, torch.int32, dev, ids.numel())
    _check("F", F, torch.int32, dev, ids.numel())
    _check_state(slot=slot, device=dev)
    _check("acc_r", acc_r, torch.int32, dev, HIST_BUCKETS * K_CAP)
    lib = _load()
    _run(dev, lib.bpe_batch_hist_rev, _ptr(ids), _ptr(seg), _ptr(n),
         _ptr(cand), _ptr(F), _ptr(slot), ids.numel(), _ptr(acc_r))
    BATCH_HIST_REV.launches += 1


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


def batch_apply(ids, n, cand, slot, acc, ctl, log, M: int, ids_out, live):
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
    lib = _load()
    _run(dev, lib.bpe_batch_apply, _ptr(ids), _ptr(n), _ptr(cand),
         _ptr(slot), _ptr(acc), _ptr(ctl), _ptr(log), M, cap,
         _ptr(ids_out), _ptr(live))
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
    agg = torch.empty(_tiles(cap), dtype=torch.int32, device=dev)
    lib = _load()
    _run(dev, lib.bpe_compact, _ptr(ids), _ptr(seg), _ptr(live), _ptr(n),
         _ptr(slot), cap, _ptr(ids_out), _ptr(seg_out), _ptr(n_out),
         _ptr(agg))
    COMPACT.launches += 1
    return ids_out, seg_out, n_out


# ---------------------------------------------------------------------------
# K9 pair_count
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
    cnt = torch.empty((V, V), dtype=torch.int32, device=dev)
    lib = _load()
    _run(dev, lib.bpe_pair_count, _ptr(ids), _ptr(seg), _ptr(n), _ptr(cnt),
         V, ids.numel())
    PAIR_COUNT.launches += 1
    return cnt
