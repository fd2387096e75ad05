"""The port's trainer on the large-corpus route against minbpe_tpu's
segmented XL trainer, and the route's bounds.

minbpe_tpu trains streams of 4M..48M tokens with ``train_merges_fused_xl``
(2M-token HBM segments swept by a Pallas grid with cross-segment carries).
The port trains them with the same kernels as every other stream, over the
whole stream at once. Here both run on the corpora of tests/test_fused_xl.py
(tiny 16K-token segments in interpret mode force the multi-segment paths; a
seeded text blob stands in for the reference corpus, and every multi-segment
corpus spans three segments, so the Pallas trainer compiles twice, for one
segment and for three): merges, counts, the
fail round and the rebuild count must be equal. Then the bounds: above
XL_MAX_N "auto" takes the sort-round route, and between 4M and XL_MAX_N the
whole-run trainer trains."""

import random

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import minbpe_tpu.ops.pallas.fused_train_xl as fx  # noqa: E402

from minbpe_tpu_torch import engine  # noqa: E402
from minbpe_tpu_torch.ops import stream as port_stream  # noqa: E402
from minbpe_tpu_torch.ops import train as port_train  # noqa: E402

SEG = 16384  # tiny test segments (128 rows), as tests/test_fused_xl.py


def _blob(seed, size):
    """Seeded text-like bytes standing in for a corpus slice."""
    rng = random.Random(seed)
    words = [bytes(rng.choice(b"etaoinshrdlu")
                   for _ in range(rng.randint(1, 7))) for _ in range(300)]
    out = bytearray()
    while len(out) < size:
        out += rng.choice(words) + rng.choice([b" ", b" ", b", ", b".\n"])
    return bytes(out[:size])


def _run_xl(chunks, M):
    """minbpe_tpu's XL trainer, fed as tests/test_fused_xl.py feeds it."""
    data = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    ends = np.cumsum([len(c) for c in chunks])
    lens = np.diff(ends, prepend=0)
    ecap = max(128, 1 << (len(ends) - 1).bit_length())
    if lens.max(initial=0) < (1 << 16):
        e = np.zeros(ecap, np.uint16)
        e[:len(ends)] = lens
    else:
        cap = -(-len(data) // SEG) * SEG
        e = np.full(ecap, cap, np.int32)
        e[:len(ends)] = ends
    return fx.train_merges_fused_xl(data, e, len(data), M, interpret=True,
                                    seg_tokens=SEG)


def _run_port(chunks, M):
    data = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    ends = np.cumsum([len(c) for c in chunks])
    ids, seg = port_stream.build_stream(data, ends, "cpu")
    return port_train.train_merges(ids, seg, M)


def _check(chunks, M):
    p1, c1, f1 = _run_xl(chunks, M)
    p2, c2, f2 = _run_port(chunks, M)
    assert int(f1) == f2
    assert np.array_equal(np.asarray(p1), p2)
    assert np.array_equal(np.asarray(c1), c2)
    assert port_train.LAST_REBUILDS == fx.LAST_REBUILDS
    return f2


def _multisegment_corpus():
    text = _blob(2, 45000)
    ends = list(range(11, len(text), 13)) + [len(text)]
    return [text[a:b] for a, b in zip([0] + ends, ends) if b > a], 40


def _single_segment():
    text = _blob(3, 12000)
    return [text[a:b] for a, b in zip([0, 500, 7000], [500, 7000, 12000])], 24


def _overlap_runs_cross_boundary_kills():
    rng = random.Random(5)
    parts = []
    for _ in range(2600):
        parts.append(bytes([rng.randint(0, 3)]) * rng.randint(1, 9))
    blob = b"".join(parts)
    ends = list(range(700, len(blob), 1117)) + [len(blob)]
    return [blob[a:b] for a, b in zip([0] + ends, ends) if b > a], 24


def _tie_heavy_small_alphabet():
    rng = random.Random(11)
    blob = bytes(rng.randint(0, 5) for _ in range(33000))
    return [blob[i:i + 977] for i in range(0, len(blob), 977)], 32


def _boundary_inside_chunk():
    return [_blob(4, 40000)], 24


def _batch_sites_straddle_segments():
    rng = random.Random(41)
    words = [b"ab", b"ac", b"ad", b"bx", b"cx", b"th", b"he"]
    parts = []
    total = 0
    while total < 2 * SEG + 1000:
        w = words[rng.randrange(len(words))]
        parts.append(w + bytes([rng.randint(128, 255)]))
        total += len(parts[-1])
    return parts, 40


def _hot_pair_at_every_boundary():
    filler = bytes(range(128, 200))
    seg_fill = filler * (SEG // len(filler))
    parts = []
    for k in range(2):
        parts.append(seg_fill[: SEG - 1 - (k % 2)])
        parts.append(b"qz" * 40)
    parts.append(b"qz" * 200)
    return parts, 12


CORPORA = {
    "multisegment_corpus_with_compactions": _multisegment_corpus,
    "single_segment_degenerates": _single_segment,
    "overlap_runs_cross_boundary_kills": _overlap_runs_cross_boundary_kills,
    "tie_heavy_small_alphabet": _tie_heavy_small_alphabet,
    "segment_boundary_inside_chunk": _boundary_inside_chunk,
    "batch_sites_straddle_segments": _batch_sites_straddle_segments,
    "batch_hot_pair_at_every_boundary": _hot_pair_at_every_boundary,
}


@pytest.mark.parametrize("name", list(CORPORA))
def test_matches_xl_trainer(name):
    chunks, M = CORPORA[name]()
    _check(chunks, M)


def test_exhaustion_fail_round():
    assert _check([b"ababab", b"cdcd"], 16) < 16


# ---------------------------------------------------------------------------
# the route's bounds
# ---------------------------------------------------------------------------

def test_bound_is_the_xl_trainers():
    assert port_train.TRAIN_MAX_N == port_train.XL_MAX_N == fx.XL_MAX_N


def test_above_xl_max_raises_a11_before_building_a_stream(monkeypatch):
    """Above XL_MAX_N (where training once raised NotImplementedError before
    a stream was built) "auto" takes the sort-round route: the stepped
    sort-round trainer runs, and no whole-run trainer is called."""
    N = port_train.XL_MAX_N + 1
    calls = []

    def whole(*args, **kwargs):
        raise AssertionError("a whole-run trainer was called")

    def sortloop(ids, seg, num_merges, **kwargs):
        calls.append(ids.numel())
        pairs = np.stack([np.arange(num_merges)] * 2, axis=1).astype(np.int32)
        return pairs, np.ones(num_merges, np.int32), num_merges

    def stream(data, ends, device):
        # a read-only view of one id: the size of a stream, none of its
        # memory
        ids = torch.zeros(1, dtype=torch.int32).expand(data.shape[0])
        return ids, ids

    for name in ("train_merges", "train_merges_sortloop", "train_merges_sparse",
                 "train_merges_incremental"):
        monkeypatch.setattr(engine, name, whole)
    monkeypatch.setattr(engine, "train_merges_sortloop_stepped", sortloop)
    monkeypatch.setattr(port_stream, "build_stream", stream)
    data = np.broadcast_to(np.uint8(97), (N,))
    ends = np.array([N], np.int64)
    merges, _ = engine.train_offsets(data, ends, 10, device="cpu")
    assert len(merges) == 10 and calls == [N]
    assert engine.train_route("auto", N, 10) == "sortloop"
    ids = torch.zeros(1, dtype=torch.int32).expand(N)
    engine.run_train(ids, ids, 10)
    assert calls == [N, N]


def test_between_4m_and_xl_max_trains():
    """5M bytes: above the in-VMEM trainer's 4M ceiling, inside the XL
    bound. With no merges requested nothing trains, but the route runs."""
    n = 5 << 20
    data = np.frombuffer(_blob(6, 1 << 16) * (n >> 16), dtype=np.uint8)
    ends = np.arange(4096, n + 1, 4096, dtype=np.int64)
    merges, vocab = engine.train_offsets(data, ends, 0, device="cpu")
    assert merges == {} and len(vocab) == 256


def test_device_bytes_at_xl_max():
    """The trainer's device memory at 48M tokens and vocab 1024: ~2.3 GiB
    of the card's 80 GB."""
    need = port_train.device_bytes(port_train.XL_MAX_N, 768)
    assert need == port_train.BYTES_PER_TOKEN * (48 << 20) + 8 * 1024 * 1024
    assert need < 3 << 30


def test_too_little_device_memory_raises(monkeypatch):
    """The check the trainer makes on the card before it allocates: a clear
    MemoryError, not a fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    dev = torch.device("cuda")
    port_train._check_memory(dev, 12 << 20, 768)  # 0.6 GiB fits in 1 GiB
    with pytest.raises(MemoryError, match="GiB"):
        port_train._check_memory(dev, port_train.XL_MAX_N, 768)
