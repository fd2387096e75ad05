"""The CUDA kernels of the main path, their build, bindings and plain twins.

Four kernels (csrc/bpe_kernels.cu) carry training and encode over a dense
token stream (ids, seg) whose live length n is an int32[1] tensor on the
same device, so a whole run launches without host syncs:

- ``pair_stats``  K1: exact pair counts and first positions (W x W);
- ``select_best`` K2: the reference's argmax with its first-occurrence
  tie-break, written to a merge-log row, or the fail round;
- ``merge_apply`` K3: apply one merge everywhere, left first;
- ``compact``     K4: order-preserving compaction by the live mask.

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
    ":251-290, count_width/count_blocked/count_full :816-891)")
SELECT_BEST = KernelInfo(
    "select_best",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: select_candidate "
    ":915-1000, no_pair :1118-1123)")
MERGE_APPLY = KernelInfo(
    "merge_apply",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: tiled_apply "
    ":293-340); minbpe_tpu/ops/pallas/fused_encode.py:45 (_kernel: "
    "per-rank body :58-87)")
COMPACT = KernelInfo(
    "compact",
    "minbpe_tpu/ops/pallas/fused_train.py:754 (_kernel: _compact_inplace "
    ":641-736); minbpe_tpu/ops/pallas/fused_encode.py:45 (_kernel: output "
    "compaction :91-119)")
KERNELS = (PAIR_STATS, SELECT_BEST, MERGE_APPLY, COMPACT)


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
            "bpe_pair_stats": [P, P, P, P, I, P, P, I, I, P],
            "bpe_select_best": [P, P, I, P, P, I, P, P, P],
            "bpe_merge_apply": [P, P, P, P, I, P, I, I, P, P, P, P, P],
            "bpe_compact": [P, P, P, P, P, I, I, P, P, P, P, P],
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


def _tiles(cap: int) -> int:
    tile = _load().bpe_tile_size()
    return max(1, -(-cap // tile))


def _stopped(stop, r: int) -> bool:
    return stop is not None and int(stop.item()) <= r


# ---------------------------------------------------------------------------
# K1 pair_stats
# ---------------------------------------------------------------------------

def pair_stats_plain(ids, seg, n, W: int, stop, r: int):
    """(cnt, first): int32 (W, W) pair counts and first positions (-1 where
    absent) over the countable pairs of ids[:n] whose ids are below W."""
    WW = W * W
    nn = int(n.item())
    if _stopped(stop, r) or nn < 2:
        return (torch.zeros((W, W), dtype=torch.int32, device=ids.device),
                torch.full((W, W), -1, dtype=torch.int32, device=ids.device))
    a, b = ids[:nn - 1], ids[1:nn]
    ok = ((seg[:nn - 1] == seg[1:nn]) & (a >= 0) & (a < W)
          & (b >= 0) & (b < W))
    # pairs that do not count go to one extra bin, dropped at the end
    key = torch.where(ok, a.long() * W + b.long(), WW)
    cnt = torch.bincount(key, minlength=WW + 1)[:WW].to(torch.int32)
    none = 1 << 40
    first = torch.full((WW + 1,), none, dtype=torch.int64, device=ids.device)
    first.scatter_reduce_(0, key, torch.arange(nn - 1, device=ids.device),
                          "amin")
    first = torch.where(first == none, -1, first)[:WW].to(torch.int32)
    return cnt.view(W, W), first.view(W, W)


def pair_stats(ids, seg, n, W: int, stop=None, r: int = 0):
    if not ids.is_cuda:
        return pair_stats_plain(ids, seg, n, W, stop, r)
    dev = ids.device
    _check_stream(ids, seg, n)
    if stop is not None:
        _check("stop", stop, torch.int32, dev)
    cnt = torch.empty((W, W), dtype=torch.int32, device=dev)
    first = torch.empty((W, W), dtype=torch.int32, device=dev)
    lib = _load()
    _run(dev, lib.bpe_pair_stats, _ptr(ids), _ptr(seg), _ptr(n), _ptr(stop),
         r, _ptr(cnt), _ptr(first), W, ids.numel())
    PAIR_STATS.launches += 1
    return cnt, first


# ---------------------------------------------------------------------------
# K2 select_best
# ---------------------------------------------------------------------------

def select_best_plain(cnt, first, ids, fail, r: int, row):
    """Write (pa, pb, count) of the most frequent pair, earliest first
    occurrence among equals, into row[:3]; or set fail to r if no pair."""
    if _stopped(fail, r):
        return
    c = cnt.reshape(-1).long()
    f = first.reshape(-1).long() & 0xFFFFFFFF
    key = torch.where(c > 0, (c << 32) | (0xFFFFFFFF - f),
                      torch.zeros_like(c))
    best = int(key.max())
    if best == 0:
        fail.fill_(r)
        return
    pos = 0xFFFFFFFF - (best & 0xFFFFFFFF)
    row[0] = ids[pos]
    row[1] = ids[pos + 1]
    row[2] = best >> 32


def select_best(cnt, first, ids, fail, r: int, row):
    if not ids.is_cuda:
        return select_best_plain(cnt, first, ids, fail, r, row)
    dev = ids.device
    _check("cnt", cnt, torch.int32, dev)
    _check("first", first, torch.int32, dev, cnt.numel())
    _check("ids", ids, torch.int32, dev, 0)
    _check("fail", fail, torch.int32, dev)
    _check("row", row, torch.int32, dev, 3)
    scratch = torch.empty(2, dtype=torch.int64, device=dev)
    lib = _load()
    _run(dev, lib.bpe_select_best, _ptr(cnt), _ptr(first), cnt.numel(),
         _ptr(ids), _ptr(fail), r, _ptr(row), _ptr(scratch))
    SELECT_BEST.launches += 1


# ---------------------------------------------------------------------------
# K3 merge_apply
# ---------------------------------------------------------------------------

def merge_apply_plain(ids, seg, n, pair, z: int, stop=None, r: int = 0,
                      kept=None):
    """(ids_out, live): pair (pair[0], pair[1]) -> z at every occurrence in
    ids[:n], left first; live[i] is False for the token consumed by a kept
    match. Adds the kept count to kept[0] when given."""
    ids_out = ids.clone()
    live = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    nn = int(n.item())
    if _stopped(stop, r) or nn < 2:
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


def merge_apply(ids, seg, n, pair, z: int, stop=None, r: int = 0,
                kept=None):
    if not ids.is_cuda:
        return merge_apply_plain(ids, seg, n, pair, z, stop, r, kept)
    dev = ids.device
    _check_stream(ids, seg, n)
    _check("pair", pair, torch.int32, dev, 2)
    if stop is not None:
        _check("stop", stop, torch.int32, dev)
    if kept is not None:
        _check("kept", kept, torch.int32, dev)
    cap = ids.numel()
    ids_out = torch.empty_like(ids)
    live = torch.empty(cap, dtype=torch.bool, device=dev)
    agg = torch.empty(_tiles(cap), dtype=torch.int32, device=dev)
    lib = _load()
    _run(dev, lib.bpe_merge_apply, _ptr(ids), _ptr(seg), _ptr(n),
         _ptr(pair), z, _ptr(stop), r, cap, _ptr(ids_out), _ptr(live),
         _ptr(kept), _ptr(agg))
    MERGE_APPLY.launches += 1
    return ids_out, live


# ---------------------------------------------------------------------------
# K4 compact
# ---------------------------------------------------------------------------

def compact_plain(ids, seg, live, n, stop=None, r: int = 0):
    """(ids_out, seg_out, n_out): the live tokens of ids[:n], seg[:n] moved
    to the front in order; n_out is their count (int32[1])."""
    if _stopped(stop, r):
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


def compact(ids, seg, live, n, stop=None, r: int = 0):
    if not ids.is_cuda:
        return compact_plain(ids, seg, live, n, stop, r)
    dev = ids.device
    _check_stream(ids, seg, n)
    _check("live", live, torch.bool, dev, ids.numel())
    if stop is not None:
        _check("stop", stop, torch.int32, dev)
    cap = ids.numel()
    ids_out = torch.empty_like(ids)
    seg_out = torch.empty_like(seg)
    n_out = torch.empty_like(n)
    agg = torch.empty(_tiles(cap), dtype=torch.int32, device=dev)
    lib = _load()
    _run(dev, lib.bpe_compact, _ptr(ids), _ptr(seg), _ptr(live), _ptr(n),
         _ptr(stop), r, cap, _ptr(ids_out), _ptr(seg_out), _ptr(n_out),
         _ptr(agg))
    COMPACT.launches += 1
    return ids_out, seg_out, n_out
