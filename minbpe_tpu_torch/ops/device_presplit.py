"""Device GPT-2/GPT-4 pre-split: per-byte chunk boundaries and segment ids
of a UTF-8 byte stream, computed on the stream's device.

The port's counterpart of minbpe_tpu/ops/device_presplit.py, with its
public functions and contracts: ``presplit_seg_ids(data, n, mode)`` and
``split_spans_host(text, mode, device="cuda")``. A mode is "gpt4" or
"gpt2", or its code 4 or 2, the tokenizers' scanner mode. Only the raw
bytes cross to the device;
the split, and after it the stream build and the encode's rank sweep
(engine.encode_text_device_split), run there. Given ``byte_ids``, an int32
table of 256 token ids on the data's device, the split also returns each
byte's token id, ``byte_ids[data]``: the kernels write it beside the
segment ids, so the stream that the encode takes needs no launch of its
own.

On a CUDA tensor the split is K15, two hand-written kernels
(csrc/bpe_kernels.cu): ``presplit_succ`` finds, for every char start,
where the chunk that would start there ends, working in bytes with scans
over class runs chained across tiles; ``presplit_orbit`` follows those ends
from byte 0 (each tile's exits, then the path over the tiles' exits by
doubling) and writes the boundaries and segment ids. A stream of at most
``CLUSTER_MAX_N`` (32 KB) bytes takes ``presplit_cluster`` instead: both
steps in one launch of one thread-block cluster, a CTA a tile, the
successors and walks in shared memory (``route(n)`` chooses, by n alone,
and counts each call in ``presplit.route.cluster`` or
``presplit.route.grid``). On a CPU tensor it is
``presplit_plain``, the plain PyTorch twin: minbpe_tpu's array program
(UTF-8 decode, class lookup, every char's successor from cummin/cummax
scans, the orbit by pointer doubling) carried over op by op. Each kernel
also has a plain version of its own step, in bytes: ``successor_plain``
and ``orbit_plain``; and ``succ_tiles_model``, ``orbit_tiles_model`` and
``cluster_tiles_model`` carry out the kernels' tile steps in plain PyTorch
at any tile size and grid or cluster, so the CPU tests hold the design
itself to the plain steps.

The class tables (dense BMP flags, 64 KB; the range starts and flags for
the astral planes) come from the port's own utils/presplit tables and go to
each device once.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from .. import kernels, trace
from ..utils.presplit import (
    FLAG_C1, FLAG_CI_E, FLAG_CI_L, FLAG_CI_R, FLAG_CI_V, FLAG_L, FLAG_N,
    FLAG_WS, _load,
)

# the kernels' mode codes, which are also regex.py's scanner modes
MODES = {"gpt4": 4, "gpt2": 2}
# the kernels index bytes with int32 (two tiles of slack)
MAX_N = 2**31 - 2**13
# presplit_cluster's most bytes: a tile each of its cluster's CTAs
CLUSTER_MAX_N = kernels.PRESPLIT_CLUSTER_MAX * kernels.PRESPLIT_TILE
# device bytes a text byte takes in the split: the bytes, the successors,
# the orbit's scratch (each tile's exits, the node graph's two buffers), the
# boundaries, the segment ids
BYTES_PER_BYTE = 22

_BIG = 2**30
_TABLES: dict = {}


def _device_tables(device):
    """(dense flags uint8[0x10000], range starts int32, their flags uint8)
    on ``device``, sent there once."""
    key = str(device)
    tabs = _TABLES.get(key)
    if tabs is None:
        starts, flags, dense = _load()
        trace.count("sync.presplit.tables", 3)
        tabs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (dense.astype(np.uint8),
                               starts.astype(np.int32),
                               flags.astype(np.uint8)))
        _TABLES[key] = tabs
    return tabs


def mode_code(mode) -> int | None:
    """4 (GPT-4) or 2 (GPT-2) of a split named "gpt4"/"gpt2" or given by
    that code; None for any other."""
    code = MODES.get(mode, mode) if isinstance(mode, (str, int)) else None
    return code if code in MODES.values() else None


def _check_args(data, n: int, mode, byte_ids=None) -> int:
    """mode's code, once the arguments are checked."""
    code = mode_code(mode)
    if code is None:
        raise ValueError(f"unknown mode {mode!r}")
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError("data: expected a 1-D uint8 tensor")
    if not 0 <= n <= data.numel():
        raise ValueError(f"n = {n} outside 0 .. {data.numel()}")
    if n > MAX_N:
        raise ValueError(f"{n} bytes: the pre-split takes at most {MAX_N}")
    if byte_ids is not None:
        _check_byte_ids(byte_ids, data.device)
    return code


def _check_byte_ids(byte_ids, device):
    kernels._check("byte_ids", byte_ids, torch.int32, device, 256)
    if byte_ids.shape != (256,):
        raise ValueError("byte_ids: expected 256 token ids")


def _with_ids(out, data, byte_ids):
    """A split's (boundary, seg), and with ``byte_ids`` each byte's token
    id after them: the plain twins' ``byte_ids[data]``."""
    if byte_ids is None:
        return out
    return (*out, byte_ids[data.long()])


# ---------------------------------------------------------------------------
# the plain twin, in chars (minbpe_tpu/ops/device_presplit.py:56-233)
# ---------------------------------------------------------------------------

def _shift_next(x, k: int, fill):
    """x[i + k], out of range -> fill."""
    k = min(k, x.numel())
    if not k:
        return x
    return torch.cat([x[k:], torch.full((k,), fill, dtype=x.dtype,
                                        device=x.device)])


def _rev_cummin(x):
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def _next_non(mask, idx):
    """Smallest j >= i with mask[j] False."""
    return _rev_cummin(torch.where(~mask, idx, _BIG))


def _gather(a, i):
    """a[i], with i clipped into a."""
    return a[i.clamp(0, a.numel() - 1).long()]


def _decode_utf8(data):
    """Per-byte (is_start, code point at a start) of a valid UTF-8 stream."""
    b = data.to(torch.int32)
    is_start = (b & 0xC0) != 0x80
    b1, b2, b3 = (_shift_next(b, k, 0) for k in (1, 2, 3))
    cp = torch.where(
        b < 0x80, b,
        torch.where(
            (b & 0xE0) == 0xC0, ((b & 0x1F) << 6) | (b1 & 0x3F),
            torch.where(
                (b & 0xF0) == 0xE0,
                ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F),
                ((b & 0x07) << 18) | ((b1 & 0x3F) << 12)
                | ((b2 & 0x3F) << 6) | (b3 & 0x3F))))
    return is_start, cp


def _char_flags(cp):
    dense, starts, flags = _device_tables(cp.device)
    f_bmp = _gather(dense, cp).to(torch.int32)
    hi = torch.searchsorted(starts, cp, right=True) - 1
    f_ast = _gather(flags, hi).to(torch.int32)
    return torch.where(cp < 0x10000, f_bmp, f_ast)


def _orbit(J, n_items: int):
    """Visited set of {0, J[0], J[J[0]], ...} below n_items, by pointer
    doubling: each round squares the jump table and scatters the
    frontier."""
    NC = J.numel()
    ar = torch.arange(NC, dtype=torch.int32, device=J.device)
    Jx = torch.where(ar < n_items, J.clamp(max=NC), NC)
    visited = (ar == 0) & (n_items > 0)
    sentinel = torch.full((1,), NC, dtype=Jx.dtype, device=J.device)
    for _ in range(max(1, (NC - 1).bit_length())):
        tgt = torch.where(visited, Jx, NC).long()
        hit = torch.zeros(NC + 1, dtype=torch.bool, device=J.device)
        hit[tgt] = True
        visited = visited | hit[:NC]
        Jx = torch.minimum(_gather(torch.cat([Jx, sentinel]), Jx), sentinel)
    return visited


def _successor(cp, F, idx, n: int, mode: int):
    """f(i): end of the span the scanner would emit starting at char i, in
    utils/presplit.py's alternative order."""
    valid = idx < n
    L = valid & ((F & FLAG_L) != 0)
    Nd = valid & ((F & FLAG_N) != 0)
    WS = valid & ((F & FLAG_WS) != 0)
    CRLF = valid & ((cp == 10) | (cp == 13))
    OTHER = valid & ~L & ~Nd & ~WS
    APOS = valid & (cp == 39)
    SP = valid & (cp == 32)

    next_non_l = _next_non(L, idx).clamp(max=n)
    next_non_n = _next_non(Nd, idx).clamp(max=n)
    next_non_ws = _next_non(WS, idx).clamp(max=n)
    next_non_other = _next_non(OTHER, idx).clamp(max=n)
    next_non_crlf = _next_non(CRLF, idx).clamp(max=n)
    last_crlf = torch.cummax(torch.where(CRLF, idx, -1), 0).values
    nvec = torch.full((1,), n, dtype=idx.dtype, device=idx.device)
    none = torch.full((1,), -1, dtype=idx.dtype, device=idx.device)
    false = torch.zeros(1, dtype=torch.bool, device=idx.device)

    def gat_pos(a, i):
        """Gather from a positions array; index n (the buffer end) -> n."""
        return _gather(torch.cat([a, nvec]), i)

    def gat_mask(m, i):
        return _gather(torch.cat([m, false]), i)

    F1 = _shift_next(F, 1, 0)
    F2 = _shift_next(F, 2, 0)
    cp1 = _shift_next(cp, 1, -1)
    cp2 = _shift_next(cp, 2, -1)
    L1 = _shift_next(L, 1, False)

    f = torch.full_like(idx, -1)

    def put(pred, val):
        return torch.where((f < 0) & pred, val, f)

    if mode == 4:
        # P1: '(?i:[sdmt]|ll|ve|re)
        c1 = (F1 & FLAG_C1) != 0
        ci2 = ((((F1 & FLAG_CI_L) != 0) & ((F2 & FLAG_CI_L) != 0))
               | (((F1 & FLAG_CI_V) != 0) & ((F2 & FLAG_CI_E) != 0))
               | (((F1 & FLAG_CI_R) != 0) & ((F2 & FLAG_CI_E) != 0)))
        p1 = APOS & (idx + 1 < n)
        f = put(p1 & c1, idx + 2)
        f = put(p1 & ~c1 & (idx + 2 < n) & ci2, idx + 3)
        # P2: [^\r\n\p{L}\p{N}]?+ \p{L}+
        f = put(L, next_non_l)
        f = put(~L & ~Nd & ~CRLF & valid & L1, gat_pos(next_non_l, idx + 1))
        # P3: \p{N}{1,3}
        f = put(Nd, torch.minimum(next_non_n, idx + 3))
        # P4: " "? [^\s\p{L}\p{N}]++ [\r\n]*
        k4 = torch.where(SP & (idx + 1 < n), idx + 1, idx)
        other4 = gat_mask(OTHER, k4)
        end4 = gat_pos(next_non_other, k4)
        f = put(valid & other4, gat_pos(next_non_crlf, end4))
        # P5/P6/P7: \s*[\r\n] | \s+(?!\S) | \s+
        kws = next_non_ws
        lnl = _gather(torch.cat([last_crlf, none]), kws - 1)
        f = put(WS & (lnl >= idx), lnl + 1)
        f = put(WS & (kws >= n), kws)
        f = put(WS & (kws - idx >= 2), kws - 1)
        f = put(WS, kws)
    elif mode == 2:
        # Q1: '([sdmt]|ll|ve|re) exact case
        q1 = APOS & (idx + 1 < n)
        c1 = (cp1 == 115) | (cp1 == 100) | (cp1 == 109) | (cp1 == 116)
        c2 = (((cp1 == 108) & (cp2 == 108)) | ((cp1 == 118) & (cp2 == 101))
              | ((cp1 == 114) & (cp2 == 101)))
        f = put(q1 & c1, idx + 2)
        f = put(q1 & ~c1 & (idx + 2 < n) & c2, idx + 3)
        # Q2/Q3/Q4: " "? (\p{L}+ | \p{N}+ | [^\s\p{L}\p{N}]+)
        k = torch.where(SP, idx + 1, idx)
        f = put(valid & gat_mask(L, k), gat_pos(next_non_l, k))
        f = put(valid & gat_mask(Nd, k), gat_pos(next_non_n, k))
        f = put(valid & gat_mask(OTHER, k), gat_pos(next_non_other, k))
        # Q5/Q6: \s+(?!\S) | \s+
        kws = next_non_ws
        f = put(WS & (kws >= n), kws)
        f = put(WS & (kws - idx >= 2), kws - 1)
        f = put(WS, kws)
    else:  # pragma: no cover
        raise ValueError(f"unknown mode {mode!r}")
    return torch.where(valid & (f > idx), f, _BIG)


def _chars(data, n: int):
    """(is_start, char_of_byte, cp, F, n_chars) of data with n valid bytes:
    the per-char code points and flags compacted to char k's slot."""
    NB = data.numel()
    bidx = torch.arange(NB, dtype=torch.int32, device=data.device)
    bvalid = bidx < n
    is_start, cp_b = _decode_utf8(torch.where(bvalid, data, 0x41))
    is_start = is_start & bvalid
    char_of_byte = torch.cumsum(is_start.to(torch.int32), 0,
                                dtype=torch.int32) - 1
    n_chars = max(int(char_of_byte[-1]) + 1, 0)
    cp = torch.zeros(NB, dtype=torch.int32, device=data.device)
    cp[char_of_byte[is_start].long()] = cp_b[is_start]
    return is_start, char_of_byte, cp, _char_flags(cp), n_chars


def presplit_plain(data, n: int, mode, byte_ids=None):
    """K15's plain twin (minbpe_tpu's _presplit_device, :208-233): per-byte
    (boundary bool, seg int32) of uint8 ``data`` whose first n bytes are
    valid UTF-8; seg[i] is the index of the chunk byte i belongs to; with
    ``byte_ids``, each byte's token id (int32) after them. Values past n
    are unspecified."""
    mode = _check_args(data, n, mode, byte_ids)
    if data.numel() == 0:
        return _with_ids(
            (torch.zeros(0, dtype=torch.bool, device=data.device),
             torch.zeros(0, dtype=torch.int32, device=data.device)),
            data, byte_ids)
    is_start, char_of_byte, cp, F, n_chars = _chars(data, n)
    cidx = torch.arange(data.numel(), dtype=torch.int32, device=data.device)
    f = _successor(cp, F, cidx, n_chars, mode)
    starts_chunk = _orbit(f, n_chars)
    false = torch.zeros(1, dtype=torch.bool, device=data.device)
    boundary = is_start & _gather(torch.cat([starts_chunk, false]),
                                  char_of_byte)
    seg = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    return _with_ids((boundary, seg), data, byte_ids)


# ---------------------------------------------------------------------------
# the kernels' own steps, in bytes
# ---------------------------------------------------------------------------

# byte classes, as csrc/bpe_kernels.cu numbers them
_CL_L, _CL_N, _CL_O, _CL_WS, _CL_CR = range(5)


def _byte_state(data, n: int):
    """Per-byte arrays of data[:n] (n >= 1) that presplit_succ reads: the
    positions, char starts, lead-byte lengths, code points and flags at
    starts, each byte's char class and lead, and where a coarse class run
    (brk_c) and a GPT-4 [^\\s\\p{L}\\p{N}]++[\\r\\n]* span (brk_o) break."""
    dev = data.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    b = data[:n].to(torch.int64)
    start = (b & 0xC0) != 0x80
    ln = torch.where(b < 0x80, 1, torch.where(
        (b & 0xE0) == 0xC0, 2, torch.where((b & 0xF0) == 0xE0, 3, 4)))
    _, cp = _decode_utf8(data[:n])
    cp = cp.to(torch.int64)
    F = _char_flags(cp.to(torch.int32)).to(torch.int64)
    cls = torch.where((F & FLAG_L) != 0, _CL_L, torch.where(
        (F & FLAG_N) != 0, _CL_N, torch.where(
            (F & FLAG_WS) != 0,
            torch.where((cp == 10) | (cp == 13), _CL_CR, _CL_WS), _CL_O)))
    # every byte takes its char's class and start
    lead = torch.cummax(torch.where(start, pos, 0), 0).values
    cls = cls[lead]
    coarse = torch.where(cls == _CL_CR, _CL_WS, cls)
    prev = torch.cat([cls[:1], cls[:-1]])
    prev_c = torch.where(prev == _CL_CR, _CL_WS, prev)
    first = pos >= 1
    brk_c = start & first & (prev_c != coarse)
    goes_on = (((prev == _CL_O) & ((cls == _CL_O) | (cls == _CL_CR)))
               | ((prev == _CL_CR) & (cls == _CL_CR)))
    brk_o = start & first & ~goes_on
    return dict(pos=pos, start=start, ln=ln, cp=cp, F=F, cls=cls, lead=lead,
                coarse=coarse, brk_c=brk_c, brk_o=brk_o)


def _breaks_plain(st, n: int):
    """(C1, C2, O1, O2, LCR) of every byte by reverse scans over the whole
    stream: the first and second break of each kind after the byte (n past
    the last), and the last CR/LF of the byte's whitespace run at or after
    it (-1 if none, or if the byte is not whitespace)."""
    pos = st["pos"]
    nn = torch.full((1,), n, dtype=torch.int64, device=pos.device)

    def after(brk):
        incl = _rev_cummin(torch.where(brk, pos, n))
        one = torch.cat([incl[1:], nn])
        return one, torch.cat([one, nn])[one]

    C1, C2 = after(st["brk_c"])
    O1, O2 = after(st["brk_o"])
    last_cr = torch.cummax(torch.where(st["cls"] == _CL_CR, pos, -1),
                           0).values
    lcr = last_cr[C1 - 1]
    lcr = torch.where((st["coarse"] == _CL_WS) & (lcr >= pos), lcr, -1)
    return C1, C2, O1, O2, lcr


def _succ_rules(st, n: int, mode: int, C1, C2, O1, O2, lcr):
    """f at every byte of data[:n] (-1 off the char starts) from the byte
    state and the breaks: utils/presplit.py's alternatives in order."""
    pos, start, ln, cp, F, cls = (st[k] for k in ("pos", "start", "ln", "cp",
                                                  "F", "cls"))
    coarse, lead = st["coarse"], st["lead"]

    def at(a, i, fill):
        """a[i] where i < n, else fill."""
        return torch.where(i < n, a[i.clamp(max=n - 1)], fill)

    p1 = pos + ln
    v1 = p1 < n
    p2 = p1 + at(ln, p1, 1)
    v2 = p2 < n
    p3 = p2 + at(ln, p2, 1)
    cp1, cp2 = at(cp, p1, -1), at(cp, p2, -1)
    cls1 = at(cls, p1, -1)
    apos = start & (cp == 39) & v1
    ws = start & (coarse == _CL_WS)
    g = torch.full((n,), -1, dtype=torch.int64, device=pos.device)

    def put(pred, val):
        return torch.where((g < 0) & pred, val, g)

    if mode == 4:
        F1, F2 = at(F, p1, 0), at(F, p2, 0)
        c1 = (F1 & FLAG_C1) != 0
        ci2 = ((((F1 & FLAG_CI_L) != 0) & ((F2 & FLAG_CI_L) != 0))
               | (((F1 & FLAG_CI_V) != 0) & ((F2 & FLAG_CI_E) != 0))
               | (((F1 & FLAG_CI_R) != 0) & ((F2 & FLAG_CI_E) != 0)))
        g = put(apos & c1, p2)
        g = put(apos & ~c1 & v2 & ci2, p3)
        g = put(start & (cls == _CL_L), C1)
        g = put(start & (cls != _CL_N) & (cls != _CL_CR) & (cls1 == _CL_L),
                C2)
        g = put(start & (cls == _CL_N), torch.where(C1 > p2, p3, C1))
        sp = (cp == 32) & v1
        g = put(start & (torch.where(sp, cls1, cls) == _CL_O),
                torch.where(sp, O2, O1))
        g = put(ws & (lcr >= 0), lcr + 1)
    else:
        c1 = (cp1 == 115) | (cp1 == 100) | (cp1 == 109) | (cp1 == 116)
        c2 = (((cp1 == 108) & (cp2 == 108)) | ((cp1 == 118) & (cp2 == 101))
              | ((cp1 == 114) & (cp2 == 101)))
        g = put(apos & c1, p2)
        g = put(apos & ~c1 & v2 & c2, p3)
        sp = cp == 32
        word = (cls1 >= 0) & (cls1 != _CL_WS) & (cls1 != _CL_CR)
        g = put(start & sp & v1 & word, C2)
        g = put(start & ~sp & (coarse != _CL_WS), C1)
    g = put(ws & (C1 >= n), C1)
    g = put(ws & (p1 < C1), lead[(C1 - 1).clamp(min=0)])
    g = put(ws, C1)
    return torch.where(start, g, -1).to(torch.int32)


def successor_plain(data, n: int, mode):
    """presplit_succ's function: int32 f of data's length, f[p] for each
    char start p < n the byte where the chunk that would start at p ends,
    -1 at every other byte. In the kernel's terms: each rule reads the
    first and second class-run break after p (C1, C2), the first and second
    break of GPT-4's [^\\s\\p{L}\\p{N}]++[\\r\\n]* (O1, O2) and the last
    CR/LF of p's whitespace run (LCR)."""
    mode = _check_args(data, n, mode)
    f = torch.full((data.numel(),), -1, dtype=torch.int32,
                   device=data.device)
    if n == 0:
        return f
    st = _byte_state(data, n)
    f[:n] = _succ_rules(st, n, mode, *_breaks_plain(st, n))
    return f


def orbit_plain(f, n: int):
    """presplit_orbit's function: per-byte (boundary bool, seg int32) of the
    chunk starts {0, f[0], f[f[0]], ...} below n (f: int32, -1 at bytes
    that start no char); values past n are unspecified."""
    NB = f.numel()
    J = torch.where(f >= 0, f, NB).to(torch.int32)
    visited = _orbit(J, n)
    pos = torch.arange(NB, device=f.device)
    boundary = visited & (pos < n)
    seg = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    return boundary, seg


# ---------------------------------------------------------------------------
# a CPU model of the kernels' tile steps, the tile size and the grid given
# ---------------------------------------------------------------------------

# an absent break in a tile aggregate (csrc/bpe_kernels.cu: presplit::BIG)
_AGG_BIG = 2**31 - 1
# presplit_orbit follows a tile's entry this many hops to its trunk before it
# marks the walk by doubling instead (csrc/bpe_kernels.cu: O_WALK)
WALK_HOPS = 16


def _agg_combine(a, b):
    """presplit::agg_combine: the aggregate (c1, c2, o1, o2, lr, lc) of a
    range followed by the range of b."""
    return (min(a[0], b[0]), min(max(a[0], b[0]), min(a[1], b[1])),
            min(a[2], b[2]), min(max(a[2], b[2]), min(a[3], b[3])),
            a[4] | b[4], a[5] if a[4] else (b[5] if b[5] >= 0 else a[5]))


def _agg_saturated(a) -> bool:
    """Whether nothing to the right of ``a`` changes a combine with it: two
    breaks of each kind and a byte that is not whitespace."""
    return a[1] < _AGG_BIG and a[3] < _AGG_BIG and a[4] == 1


def block_ranges(tiles: int, blocks: int):
    """The contiguous tile range [lo, hi) of each block of a K15 grid."""
    return [(b * tiles // blocks, (b + 1) * tiles // blocks)
            for b in range(blocks)]


def _tile_aggs(st, n: int, tile: int):
    """Each tile's aggregate (c1, c2, o1, o2, lr, lc) of the byte state
    ``st`` of data[:n], as a block's scan of the tile makes it."""
    cr = (st["cls"] == _CL_CR).tolist()
    nonws = (st["coarse"] != _CL_WS).tolist()
    bc = torch.nonzero(st["brk_c"]).flatten().tolist()
    bo = torch.nonzero(st["brk_o"]).flatten().tolist()

    def firsts(brks, lo, hi):
        i = bisect.bisect_left(brks, lo)
        got = [q for q in brks[i:i + 2] if q < hi]
        return got + [_AGG_BIG] * (2 - len(got))

    def tile_agg(t):
        lo, hi = t * tile, min((t + 1) * tile, n)
        c, o = firsts(bc, lo, hi), firsts(bo, lo, hi)
        first = next((q for q in range(lo, hi) if nonws[q]), None)
        top = hi if first is None else first
        lc = max((q for q in range(lo, top) if cr[q]), default=-1)
        return (c[0], c[1], o[0], o[1], int(first is not None), lc)

    return [tile_agg(t) for t in range(-(-n // tile))]


def _succ_from_carries(st, n: int, code: int, tile: int, carry):
    """f of data[:n] from each tile's carry (the aggregate of everything
    after the tile, the text's end included): each byte's state is its
    tile's breaks after it, then its tile's carry."""
    pos = st["pos"]
    tid = pos // tile
    tend = torch.clamp((tid + 1) * tile, max=n)
    cy = torch.tensor(carry, dtype=torch.int64, device=pos.device)[tid]
    big = torch.full_like(pos, _AGG_BIG)

    def in_tile(brk):
        nxt = torch.cat([_rev_cummin(torch.where(brk, pos, _AGG_BIG))[1:],
                         big[:1]])
        one = torch.where(nxt < tend, nxt, _AGG_BIG)
        two = torch.where(one < _AGG_BIG, nxt[one.clamp(max=n - 1)],
                          _AGG_BIG)
        return one, torch.where(two < tend, two, _AGG_BIG)

    def chain(one, two, c1, c2):
        return (torch.minimum(one, c1),
                torch.minimum(torch.maximum(one, c1), torch.minimum(two, c2)))

    C1, C2 = chain(*in_tile(st["brk_c"]), cy[:, 0], cy[:, 1])
    O1, O2 = chain(*in_tile(st["brk_o"]), cy[:, 2], cy[:, 3])
    # LCR: the tile's own [q, first non-space) if it has one, else the
    # carry's, else the tile's last CR/LF at or after q
    ns = _rev_cummin(torch.where(st["coarse"] != _CL_WS, pos, _AGG_BIG))
    ns_in = ns < tend
    top = torch.where(ns_in, ns, tend)
    last_cr = torch.cummax(torch.where(st["cls"] == _CL_CR, pos, -1),
                           0).values
    own = last_cr[(top - 1).clamp(min=0)]
    own = torch.where(own >= pos, own, -1)
    lcr = torch.where(ns_in | (cy[:, 5] < 0), own, cy[:, 5])
    lcr = torch.where(st["coarse"] == _CL_WS, lcr, -1)
    C1, C2, O1, O2 = (x.clamp(max=n) for x in (C1, C2, O1, O2))
    return _succ_rules(st, n, code, C1, C2, O1, O2, lcr)


def succ_tiles_model(data, n: int, mode, tile: int, blocks: int,
                     stats=None):
    """presplit_succ's tile steps in plain PyTorch: ``successor_plain``
    with the breaks chained across tiles of ``tile`` bytes as the kernel
    chains them. Each of ``blocks`` blocks owns a contiguous range of
    tiles; before the grid barrier it combines its tiles' aggregates from
    the left and stops at the first saturated one; after it, it combines
    the later blocks' aggregates a warp (32) at a time until one saturates
    (else the text's end), then walks its own tiles from the right, each
    tile's carry its right neighbour's aggregate combined with that one's
    carry. ``stats`` (a dict) gets the tiles that phase 1 read and the
    most look-right rounds of a block."""
    code = _check_args(data, n, mode)
    f = torch.full((data.numel(),), -1, dtype=torch.int32,
                   device=data.device)
    if n == 0:
        return f
    st = _byte_state(data, n)
    aggs = _tile_aggs(st, n, tile)
    tiles = len(aggs)
    ranges = block_ranges(tiles, min(blocks, tiles))
    end = (n, _AGG_BIG, n, _AGG_BIG, 1, -1)
    # phase 1: each block's aggregate, stopped where it saturates
    read = 0
    block_agg = []
    for lo, hi in ranges:
        g = (_AGG_BIG, _AGG_BIG, _AGG_BIG, _AGG_BIG, 0, -1)
        for t in range(lo, hi):
            g = _agg_combine(g, aggs[t])
            read += 1
            if _agg_saturated(g):
                break
        block_agg.append(g)
    # phases 2 and 3: each block's carry by a saturating look-right, then
    # its tiles' carries from the right
    carry = [None] * tiles
    most_rounds = 0
    for b, (lo, hi) in enumerate(ranges):
        g = (_AGG_BIG, _AGG_BIG, _AGG_BIG, _AGG_BIG, 0, -1)
        rounds = 0
        for k in range(b + 1, len(ranges)):
            if (k - b - 1) % 32 == 0:
                rounds += 1
            g = _agg_combine(g, block_agg[k])
            if _agg_saturated(g):
                break
        else:
            g = _agg_combine(g, end)
        most_rounds = max(most_rounds, rounds)
        for t in range(hi - 1, lo - 1, -1):
            carry[t] = g
            g = _agg_combine(aggs[t], g)
    if stats is not None:
        stats.update(tiles=tiles, phase1_tiles_read=read,
                     lookright_rounds=most_rounds)
    f[:n] = _succ_from_carries(st, n, code, tile, carry)
    return f


def _in_tile_walk(fv, tile: int, marks=None):
    """Doubling inside tiles of ``tile`` bytes over the successors fv
    (int64, -1 off a char start): (the last byte of each walk in its tile,
    the chunk starts it makes there), or with ``marks`` the bytes that the
    walks from the marked bytes visit."""
    n = fv.numel()
    pos = torch.arange(n, dtype=torch.int64, device=fv.device)
    tend = torch.clamp((pos // tile + 1) * tile, max=n)
    inside = (fv > pos) & (fv < tend)
    jump = torch.where(inside, fv, pos)
    depth = inside.to(torch.int64)
    for _ in range(max(1, (tile - 1).bit_length())):
        if marks is not None:
            hit = torch.zeros(n, dtype=torch.bool, device=fv.device)
            hit[jump[marks]] = True
            marks = marks | hit
        depth = depth + torch.where(jump != pos, depth[jump], 0)
        jump = jump[jump]
    return (jump, depth + 1) if marks is None else marks


def _tile_exits(f, n: int, tile: int):
    """(exit, count) of every byte below n: the byte where the walk from it
    leaves its tile (n past the text, -1 off a char start) and the chunk
    starts it makes in the tile."""
    fv = f[:n].to(torch.int64)
    root, cnt = _in_tile_walk(fv, tile)
    out = torch.where(fv[root] > root, fv[root].clamp(max=n), n)
    return torch.where(fv >= 0, out, -1), cnt


def orbit_nodes(f, n: int, tile: int = kernels.PRESPLIT_TILE) -> int:
    """The nodes of presplit_orbit's graph over f: the distinct exits of
    every tile (``orbit_tiles_model``, step 1)."""
    if n == 0:
        return 0
    exit_, _ = _tile_exits(f, n, tile)
    pos = torch.arange(n, dtype=torch.int64, device=f.device)
    ok = exit_ >= 0
    key = (pos[ok] // tile) * (n + 1) + exit_[ok]
    return int(torch.unique(key).numel())


def _entry_marks(f, n: int, tile: int, entry):
    """The chunk starts of data[:n] from each tile's entry (entry[t]: the
    byte where the path enters tile t, None where it skips the tile), and
    how the walks ended: each tile's walk from its entry, up to WALK_HOPS
    hops, until it meets the tile's trunk (the walk from its first char
    start) or leaves the tile; then the trunk from there on. A walk that
    does neither is marked by doubling from the entry, as the trunk is."""
    dev = f.device
    tiles = -(-n // tile)
    fv = f[:n].to(torch.int64)
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    for t in range(tiles):
        got = torch.nonzero(fv[t * tile:(t + 1) * tile] >= 0)
        if got.numel():
            first[t * tile + int(got[0])] = True
    trunk = _in_tile_walk(fv, tile, first)
    marks = torch.zeros(n, dtype=torch.bool, device=dev)
    doubled = torch.zeros(n, dtype=torch.bool, device=dev)
    outcome = {"trunk": 0, "left": 0, "doubled": 0}
    fl, tr = fv.tolist(), trunk.tolist()
    for t, e in enumerate(entry):
        if e is None:
            continue
        end = min((t + 1) * tile, n)
        x, walked = e, []
        while len(walked) < WALK_HOPS and not tr[x]:
            walked.append(x)
            if not x < fl[x] < end:
                x = None
                break
            x = fl[x]
        for q in walked:
            marks[q] = True
        if x is None:
            outcome["left"] += 1
        elif tr[x]:
            marks[x:end] |= trunk[x:end]
            outcome["trunk"] += 1
        else:
            doubled[e] = True
            outcome["doubled"] += 1
    if outcome["doubled"]:
        marks |= _in_tile_walk(fv, tile, doubled)
    return marks, outcome


def orbit_tiles_model(f, n: int, tile: int, blocks: int, stats=None):
    """presplit_orbit's tile steps in plain PyTorch: ``orbit_plain`` as the
    kernel computes it over tiles of ``tile`` bytes, with ``blocks`` blocks
    each owning a contiguous range of tiles.

    1. Each tile resolves, by doubling inside the tile, where the walk from
       each of its bytes leaves it (its exit) and how many chunk starts it
       makes there; it lists its distinct exits (a tile's nodes) and keeps,
       at each byte, the index of its exit in that list and its count.
    2. The nodes form a graph: a node, an exit of tile u landing at byte e
       of tile w, leads to e's own exit, node (w, index at e). The path
       from byte 0's exit is marked by doubling over the nodes, ceil(log2
       (nodes + 1)) rounds: in one block where the nodes and the tiles
       number at most ``kernels.PRESPLIT_BLOCK_NODES``, else grid-wide.
       Each node on the path is its tile's entry and adds its count to the
       chunk starts of its tile's block.
    3. Each tile follows the walk from its entry, at most ``WALK_HOPS``
       hops, until it meets the tile's trunk (the walk from its first char
       start, marked in step 1 by the same doubling), then takes the trunk
       from there; a walk that neither meets it nor leaves the tile in
       those hops is marked by doubling from the entry. Each block counts
       its boundaries into segment ids from the chunk starts of the blocks
       before it.

    ``stats`` (a dict) gets the node count, the most nodes of a tile, the
    tier and the rounds of step 2, and how step 3's walks ended."""
    NB = f.numel()
    dev = f.device
    boundary = torch.zeros(NB, dtype=torch.bool, device=dev)
    seg = torch.full((NB,), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return boundary, seg

    # 1. exits, counts, each tile's distinct exits
    exit_, cnt = _tile_exits(f, n, tile)
    tiles = -(-n // tile)
    lists, idx = [], torch.full((n,), -1, dtype=torch.int64, device=dev)
    for t in range(tiles):
        lo, hi = t * tile, min((t + 1) * tile, n)
        e = exit_[lo:hi]
        ok = e >= 0
        vals, inv = torch.unique(e[ok], return_inverse=True)
        lists.append(vals.tolist())
        idx[lo:hi][ok] = inv
    m = [len(v) for v in lists]
    M = sum(m)
    ranges = block_ranges(tiles, min(blocks, tiles))
    owner = [b for b, (lo, hi) in enumerate(ranges) for _ in range(lo, hi)]

    # 2. the node graph (node (t, k) at slot t * tile + k) and its path
    TERM = -1
    nodes = [(t, k) for t in range(tiles) for k in range(m[t])]

    def target(e):
        """The node of byte e's exit, TERM past the text or off a char
        start."""
        if e >= n or idx[e] < 0:
            return TERM
        return (e // tile) * tile + int(idx[e])

    J = {t * tile + k: target(lists[t][k]) for t, k in nodes}
    vis = {s: False for s in J}
    if target(0) != TERM:
        vis[target(0)] = True  # byte 0's exit: the first node of the path
    rounds = max(1, M.bit_length())
    for _ in range(rounds):
        new = dict(vis)
        for s, j in J.items():
            if vis[s] and j != TERM:
                new[j] = True
        vis = new
        J = {s: (TERM if j == TERM else J[j]) for s, j in J.items()}
    entry = [None] * tiles
    blockcount = [0] * len(ranges)
    entry[0] = 0
    blockcount[owner[0]] += int(cnt[0])
    for (t, k) in nodes:
        e = lists[t][k]
        if vis[t * tile + k] and e < n:
            w = e // tile
            entry[w] = e
            blockcount[owner[w]] += int(cnt[e])
    if stats is not None:
        one = max(M, tiles) <= kernels.PRESPLIT_BLOCK_NODES
        stats.update(tiles=tiles, nodes=M, most_nodes=max(m),
                     tier="block" if one else "grid", rounds=rounds)

    # 3. each tile's walk from its entry
    marks, outcome = _entry_marks(f, n, tile, entry)
    if stats is not None:
        stats.update(walks=outcome)
    for b, (lo, hi) in enumerate(ranges):
        if lo == hi:
            continue
        a, z = lo * tile, min(hi * tile, n)
        base = sum(blockcount[:b])
        seg[a:z] = base + torch.cumsum(marks[a:z].to(torch.int32), 0,
                                       dtype=torch.int32) - 1
    boundary[:n] = marks
    return boundary, seg


def cluster_tiles_model(data, n: int, mode, tile: int, cluster: int,
                        stats=None, byte_ids=None):
    """presplit_cluster's steps in plain PyTorch at any tile size:
    ``presplit_plain`` as one cluster of ``cluster`` CTAs computes it, CTA
    r the tile of ``tile`` bytes at r * tile (none past the text; the
    tiles at most ``cluster``, at most ``kernels.PRESPLIT_CLUSTER_MAX``).

    1. Each CTA stages its tile and scans it for the tile's aggregate;
       after a cluster barrier it reads the later CTAs' aggregates from
       their shared memory and combines them, then the text's end, into
       the carry at its tile's end, and computes its tile's successors
       from it (as ``succ_tiles_model`` from its carries).
    2. Each CTA resolves by doubling inside its tile where the walk from
       each byte leaves it (its exit) and the chunk starts it makes there,
       and marks the tile's trunk (as ``orbit_tiles_model``'s step 1).
    3. After a second barrier CTA 0 follows the path from byte 0, a load
       a hop from the CTA of the tile it enters: that byte is the tile's
       entry, and its count the tile's chunk starts. A tile's chunk starts
       before it are those of the tiles the path entered before it.
    4. After a third, each CTA marks the walk from its entry (as
       ``orbit_tiles_model``'s step 3) and writes its boundaries and
       segment ids, and with ``byte_ids`` each byte's token id from its
       staged tile.

    ``stats`` (a dict) gets the tiles, the successors of step 1 (``f``),
    the path's hops and how step 4's walks ended."""
    code = _check_args(data, n, mode, byte_ids)
    tiles = -(-n // tile)
    if not tiles <= cluster <= kernels.PRESPLIT_CLUSTER_MAX:
        raise ValueError(f"{tiles} tiles of {tile} bytes on a cluster of "
                         f"{cluster} CTAs")
    NB = data.numel()
    dev = data.device
    boundary = torch.zeros(NB, dtype=torch.bool, device=dev)
    seg = torch.full((NB,), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return _with_ids((boundary, seg), data, byte_ids)
    # 1. the carries from the later CTAs' aggregates, the successors
    st = _byte_state(data, n)
    aggs = _tile_aggs(st, n, tile)
    aggs += [(_AGG_BIG, _AGG_BIG, _AGG_BIG, _AGG_BIG, 0, -1)] * (cluster
                                                                 - tiles)
    carry = []
    for r in range(tiles):
        g = (n, _AGG_BIG, n, _AGG_BIG, 1, -1)
        for k in range(cluster - 1, r, -1):
            g = _agg_combine(aggs[k], g)
        carry.append(g)
    f = torch.full((NB,), -1, dtype=torch.int32, device=dev)
    f[:n] = _succ_from_carries(st, n, code, tile, carry)
    # 2. each byte's exit and count in its tile
    exit_, cnt = _tile_exits(f, n, tile)
    # 3. the path over the tiles in CTA 0
    entry, starts, x, hops = [None] * tiles, [0] * tiles, 0, 0
    while x < n:
        w = x // tile
        entry[w], starts[w] = x, int(cnt[x])
        x = int(exit_[x])
        hops += 1
    # 4. each tile's chunk starts from its entry, its segment ids from the
    # chunk starts before it
    marks, outcome = _entry_marks(f, n, tile, entry)
    before = 0
    for w in range(tiles):
        a, z = w * tile, min((w + 1) * tile, n)
        seg[a:z] = before + torch.cumsum(marks[a:z].to(torch.int32), 0,
                                         dtype=torch.int32) - 1
        before += starts[w]
    boundary[:n] = marks
    if stats is not None:
        stats.update(tiles=tiles, f=f, path_hops=hops, walks=outcome)
    return _with_ids((boundary, seg), data, byte_ids)


# ---------------------------------------------------------------------------
# K15 wrappers
# ---------------------------------------------------------------------------

# the blocks each kernel (0 presplit_succ, 1 presplit_orbit) can hold
# resident on a device, asked once per device
_RESIDENT: dict = {}


def _grid(dev, kind: int, n: int) -> int:
    """K15's cooperative grid over n bytes on dev: the resident blocks,
    capped at the tiles."""
    resident = _RESIDENT.get((dev.index, kind))
    if resident is None:
        with torch.cuda.device(dev):
            resident = kernels._load().bpe_presplit_grid(kind)
        if resident < 1:
            raise RuntimeError(f"presplit: no cooperative launch on {dev} "
                               f"(CUDA error {-resident})")
        _RESIDENT[(dev.index, kind)] = resident
    return min(resident, -(-n // kernels.PRESPLIT_TILE))


def presplit_succ(data, n: int, mode):
    """K15 presplit_succ: ``successor_plain`` on the card (one cooperative
    launch). f past n is unspecified there."""
    code = _check_args(data, n, mode)
    if not data.is_cuda:
        return successor_plain(data, n, code)
    dev = data.device
    kernels._check("data", data, torch.uint8, dev, 0)
    f = torch.empty(data.numel(), dtype=torch.int32, device=dev)
    if n == 0:
        return f.fill_(-1)
    dense, starts, flags = _device_tables(dev)
    grid = _grid(dev, 0, n)
    scratch = torch.empty(kernels.PRESPLIT_SCRATCH_INTS * grid,
                          dtype=torch.int32, device=dev)
    kernels._run(dev, kernels._load().bpe_presplit_succ, data.data_ptr(), n,
                 code, dense.data_ptr(), starts.data_ptr(), flags.data_ptr(),
                 starts.numel(), f.data_ptr(), scratch.data_ptr(), grid)
    kernels.PRESPLIT_SUCC.launches += 1
    return f


def presplit_orbit(f, n: int, data=None, byte_ids=None):
    """K15 presplit_orbit: ``orbit_plain`` on the card (one cooperative
    launch), for successors that jump forward (f[p] > p, or -1 off a char
    start). With ``data`` (the bytes f is of) and ``byte_ids``, each
    byte's token id after the boundaries and segment ids, written in the
    same launch. Values past n are unspecified there."""
    if (data is None) != (byte_ids is None):
        raise ValueError("data and byte_ids: both or neither")
    if data is not None:
        kernels._check("data", data, torch.uint8, f.device, f.numel())
        _check_byte_ids(byte_ids, f.device)
    if not f.is_cuda:
        return _with_ids(orbit_plain(f, n), data, byte_ids)
    dev = f.device
    kernels._check("f", f, torch.int32, dev, n)
    if n == 0:
        return _with_ids(
            (torch.zeros(f.numel(), dtype=torch.bool, device=dev),
             torch.full((f.numel(),), -1, dtype=torch.int32, device=dev)),
            data, byte_ids)
    boundary = torch.empty(f.numel(), dtype=torch.bool, device=dev)
    seg = torch.empty(f.numel(), dtype=torch.int32, device=dev)
    ids = None if data is None else torch.empty(
        f.numel(), dtype=torch.int32, device=dev)
    # each tile's exits, the node graph's two next-node buffers
    lists, nj, nj2 = torch.empty((3, n), dtype=torch.int32, device=dev)
    grid = _grid(dev, 1, n)
    tl = torch.empty(2 * -(-n // kernels.PRESPLIT_TILE), dtype=torch.int32,
                     device=dev)
    bl = torch.empty(2 * grid, dtype=torch.int32, device=dev)
    # each tile's trunk, a bit a byte
    trunk = torch.empty(tl.numel() // 2 * kernels.PRESPLIT_TILE // 32,
                        dtype=torch.int32, device=dev)
    kernels._run(dev, kernels._load().bpe_presplit_orbit, f.data_ptr(), n,
                 boundary.data_ptr(), seg.data_ptr(), lists.data_ptr(),
                 nj.data_ptr(), nj2.data_ptr(), tl.data_ptr(), bl.data_ptr(),
                 trunk.data_ptr(), *_ptrs(data, byte_ids, ids), grid)
    kernels.PRESPLIT_ORBIT.launches += 1
    return (boundary, seg) if ids is None else (boundary, seg, ids)


def _ptrs(*tensors):
    """Each tensor's device address, None (a null pointer) for None."""
    return tuple(None if t is None else t.data_ptr() for t in tensors)


def cluster_geometry(n: int) -> tuple[int, int]:
    """(tile, CTAs) of presplit_cluster on n bytes: the least tile of
    512, 1,024, 2,048 or 4,096 bytes of which the cluster's 8 CTAs hold n,
    and as many CTAs as n fills, so that a short text spreads over up to
    8 SMs."""
    tile = kernels.PRESPLIT_CLUSTER_MIN_TILE
    while kernels.PRESPLIT_CLUSTER_MAX * tile < n:
        tile *= 2
    if tile > kernels.PRESPLIT_TILE:
        raise ValueError(f"{n} bytes: presplit_cluster takes at most "
                         f"{CLUSTER_MAX_N}")
    return tile, -(-n // tile)


def presplit_cluster(data, n: int, mode, byte_ids=None):
    """K15 presplit_cluster: ``presplit_plain`` on the card for a stream of
    at most ``CLUSTER_MAX_N`` bytes, in one launch of one cluster, a CTA a
    tile (``cluster_geometry``; the successors and the walks stay in shared
    memory). With ``byte_ids``, each byte's token id after the boundaries
    and segment ids, read from the staged tile in the same launch. Values
    past n are unspecified there."""
    code = _check_args(data, n, mode, byte_ids)
    tile, ctas = cluster_geometry(n)
    if not data.is_cuda:
        return presplit_plain(data, n, code, byte_ids)
    dev = data.device
    kernels._check("data", data, torch.uint8, dev, 0)
    if n == 0:
        return _with_ids(
            (torch.zeros(data.numel(), dtype=torch.bool, device=dev),
             torch.full((data.numel(),), -1, dtype=torch.int32,
                        device=dev)),
            data, byte_ids)
    boundary = torch.empty(data.numel(), dtype=torch.bool, device=dev)
    seg = torch.empty(data.numel(), dtype=torch.int32, device=dev)
    ids = None if byte_ids is None else torch.empty(
        data.numel(), dtype=torch.int32, device=dev)
    dense, starts, flags = _device_tables(dev)
    kernels._run(dev, kernels._load().bpe_presplit_cluster, data.data_ptr(),
                 n, code, dense.data_ptr(), starts.data_ptr(),
                 flags.data_ptr(), starts.numel(), boundary.data_ptr(),
                 seg.data_ptr(), *_ptrs(byte_ids, ids), tile, ctas)
    kernels.PRESPLIT_CLUSTER.launches += 1
    return (boundary, seg) if ids is None else (boundary, seg, ids)


def route(n: int) -> str:
    """K15's route for a stream of n bytes: "cluster" (presplit_cluster,
    one launch) up to CLUSTER_MAX_N bytes, else "grid" (presplit_succ then
    presplit_orbit, two cooperative launches)."""
    return "cluster" if n <= CLUSTER_MAX_N else "grid"


def presplit_seg_ids(data, n: int, mode, byte_ids=None):
    """Per-byte (boundary, seg) of uint8 ``data`` (valid UTF-8 in [:n],
    possibly padded past n), on data's device: K15 on the card (by
    ``route(n)``, counted in ``presplit.route.<route>``), the plain twin on
    the CPU. mode: "gpt4" | "gpt2" (or 4 | 2). With ``byte_ids`` (int32
    [256] on data's device), (boundary, seg, ids): ids[i] is
    byte_ids[data[i]], written by the same launch. Values past n are
    unspecified."""
    code = _check_args(data, n, mode, byte_ids)
    if not data.is_cuda:
        return presplit_plain(data, n, code, byte_ids)
    way = route(n)
    trace.count(f"presplit.route.{way}")
    if way == "cluster":
        return presplit_cluster(data, n, code, byte_ids)
    return presplit_orbit(presplit_succ(data, n, code), n,
                          None if byte_ids is None else data, byte_ids)


def split_spans_host(text: str, mode, device="cuda"):
    """Host-visible byte spans via the device splitter (test/debug use), on
    ``device``: the card by default, the plain twin on "cpu"."""
    raw = text.encode("utf-8")
    if not raw:
        return []
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)
    boundary, _ = presplit_seg_ids(data, len(raw), mode)
    cuts = torch.nonzero(boundary[:len(raw)]).flatten().tolist()
    cuts.append(len(raw))
    return [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1)]
