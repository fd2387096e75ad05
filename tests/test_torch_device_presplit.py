"""The port's device pre-split (minbpe_tpu_torch/ops/device_presplit.py, its
plain CPU path) against minbpe_tpu's (ops/device_presplit.py, jitted on
the CPU) and the port's host scanner, boundaries and segment ids exact;
the kernels' own steps in bytes (successor_plain, orbit_plain) against the
same; and the opted-in encode (engine.encode_text_device_split) against
the host-split encode and minbpe_tpu's, with the configurations it
declines. K15 itself runs on the card: tests/test_torch_cuda.py."""

import os
import random

import numpy as np
import pytest
import torch

# The suite runs in several worker processes at once: one intra-op
# thread each keeps the plain PyTorch paths from contending for cores.
torch.set_num_threads(1)

pytest.importorskip("jax")

import minbpe_tpu  # noqa: E402
from minbpe_tpu import gpt4 as jgpt4  # noqa: E402
from minbpe_tpu.ops import device_presplit as jdp  # noqa: E402

import minbpe_tpu_torch as port  # noqa: E402
from minbpe_tpu_torch import engine, gpt4, kernels  # noqa: E402
from minbpe_tpu_torch.convert import tokenizer_from_arrays  # noqa: E402
from minbpe_tpu_torch.ops import device_presplit as pdp  # noqa: E402
from minbpe_tpu_torch.regex import (GPT2_SPLIT_PATTERN,  # noqa: E402
                                    GPT4_SPLIT_PATTERN)
from minbpe_tpu_torch.utils import golden, native, presplit  # noqa: E402
from minbpe_tpu_torch.utils.synthranks import synthetic_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("gpt4", "gpt2")
SCANNER = {"gpt4": 4, "gpt2": 2}
# every input is padded to one of these, so minbpe_tpu's jitted split
# compiles once a length and mode
BUCKETS = (512, 8192, 1 << 18)

# minbpe_tpu's tests/test_device_presplit.py cases
CASES = [
    "hello world", "Hello's world IT'S you'LL we've THEY'RE",
    "abc123456789def", "  spaces   and\t tabs ", "\n\nnewlines\r\n mix \n",
    "a b", "  b", "   b", " 1", "  1", "don't stop!!! 42x",
    "héllo wörld 你好世界 😊🎉 test", "'ll 've 're 's 'd 'm 't",
    "x'll !'ll ''ll \n'll 12'll  'll", "...1234...", "a!!!b",
    "word  \n  word", "\r\n\r\n", "trailing space ", "  ", " ", "\n",
    "𝕏 astral 𝄞 chars 🚀", "tab\ttab", "12 345 6789", "( )", "(  )",
    "a  'b", "\r\nx", " \r\n ", "'", "5", "'t",
]
# minbpe_tpu's fuzz alphabet, and the case-folding letters of GPT-4's
# contractions (long s, Kelvin sign), a wide space and an Arabic digit
ALPHA = list("abcXYZ 019'\t\n\r!.,;-_é你٦\U0001F600\U0001D11E  ")
ALPHA_WIDE = ALPHA + list("ſK　 ٣LlVvEeRr")


def _padded(raw: bytes) -> np.ndarray:
    cap = next(b for b in BUCKETS if b >= len(raw))
    out = np.zeros(cap, np.uint8)
    out[:len(raw)] = np.frombuffer(raw, np.uint8)
    return out


def _host_ends(text: str, mode: str) -> list[int]:
    ends = native.split_offsets(text.encode("utf-8"), SCANNER[mode])
    if ends is None:
        ends = presplit.split_offsets(text, SCANNER[mode])
    return [int(e) for e in ends]


def _ends(boundary, n: int) -> list[int]:
    cuts = np.flatnonzero(np.asarray(boundary)[:n]).tolist()
    return cuts[1:] + [n] if n else []


def _check(text: str, mode: str):
    """The port's split of ``text`` equals minbpe_tpu's and the host
    scanner's; the kernels' steps in bytes equal it too."""
    raw = text.encode("utf-8")
    n = len(raw)
    arr = _padded(raw)
    data = torch.from_numpy(arr)
    pb, ps = pdp.presplit_seg_ids(data, n, mode)
    assert pb.shape == ps.shape == (arr.size,)
    jb, js = jdp.presplit_seg_ids(arr, n, mode)
    assert np.array_equal(pb.numpy()[:n], np.asarray(jb)[:n])
    assert np.array_equal(ps.numpy()[:n], np.asarray(js)[:n])
    assert _ends(pb.numpy(), n) == _host_ends(text, mode)
    f = pdp.successor_plain(data, n, mode)
    ob, os_ = pdp.orbit_plain(f, n)
    assert torch.equal(ob[:n], pb[:n]) and torch.equal(os_[:n], ps[:n])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_cases(mode, case):
    _check(CASES[case], mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(4))
def test_fuzz(mode, seed):
    rng = random.Random(seed)
    alpha = ALPHA if seed < 2 else ALPHA_WIDE
    for length in (64, 300, 1500):
        _check("".join(rng.choice(alpha) for _ in range(length)), mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("part", range(3))
def test_smoke_corpus_slice(mode, part):
    text = golden.smoke_corpus(ROOT)
    raw = text.encode("utf-8")[part * 100_000:part * 100_000 + 8000]
    _check(raw.decode("utf-8", errors="ignore"), mode)


RUNS = {
    "spaces": lambda k: " " * k + "x",
    "spaces_at_end": lambda k: "ab" + " " * k,
    "letters": lambda k: " " + "a" * k + "!",
    "digits": lambda k: "1" * k + " 22",
    "crlf": lambda k: "x" + "\r\n" * (k // 2) + "  y",
    "apostrophes": lambda k: "'" * k + "ll",
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", sorted(RUNS))
@pytest.mark.parametrize("log2", [12, 16])
def test_runs(mode, kind, log2):
    """Runs far longer than a kernel tile (4,096 bytes)."""
    _check(RUNS[kind](1 << log2), mode)


@pytest.mark.parametrize("mode", MODES)
def test_astral(mode):
    _check("𝕏𝕐 astral 𝄞 chars 🚀🚀 x🚀y 𐐀𐐨 '𐐀 1𝟙2 \U0001F600  \U0001F600",
           mode)


@pytest.mark.parametrize("mode", MODES)
def test_padded_input_matches_exact(mode):
    """Pad bytes past n change no boundary or segment id below n."""
    raw = "pad me 123  ok\n 'll".encode()
    n = len(raw)
    exact = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    for pad in (b"\x00", b" ", b"a", b"1", b"\n"):
        padded = torch.frombuffer(bytearray(raw + pad * 61), dtype=torch.uint8)
        for got, want in zip(pdp.presplit_seg_ids(padded, n, mode),
                             pdp.presplit_seg_ids(exact, n, mode)):
            assert torch.equal(got[:n], want[:n])
        f = pdp.successor_plain(padded, n, mode)
        assert torch.equal(f[:n], pdp.successor_plain(exact, n, mode))
        assert (f[n:] == -1).all()


@pytest.mark.parametrize("mode", MODES)
def test_empty_and_one_char(mode):
    assert pdp.split_spans_host("", mode, device="cpu") == [] == \
        jdp.split_spans_host("", mode)
    b, s = pdp.presplit_seg_ids(torch.zeros(0, dtype=torch.uint8), 0, mode)
    assert b.numel() == s.numel() == 0
    b, s = pdp.presplit_seg_ids(torch.zeros(8, dtype=torch.uint8), 0, mode)
    assert not b.any()
    for text in ("x", "😊", " ", "\n", "7", "'"):
        _check(text, mode)
        assert pdp.split_spans_host(text, mode, device="cpu") == \
            jdp.split_spans_host(text, mode) == [(0, len(text.encode()))]


@pytest.mark.parametrize("mode", MODES)
def test_split_spans_host(mode):
    text = " | ".join(CASES)
    assert pdp.split_spans_host(text, mode, device="cpu") == \
        jdp.split_spans_host(text, mode)


def test_arguments_checked():
    data = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError):
        pdp.presplit_seg_ids(data, 4, "gpt3")
    with pytest.raises(ValueError):
        pdp.presplit_seg_ids(data, 5, "gpt4")
    with pytest.raises(TypeError):
        pdp.presplit_seg_ids(data.to(torch.int32), 4, "gpt4")


def test_cpu_wrappers_take_the_plain_steps():
    """On CPU tensors the kernel wrappers are their plain versions, and
    nothing counts as a launch."""
    raw = "Hello's world 123456 !!\r\n  x".encode()
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    kernels.reset_launches()
    f = pdp.presplit_succ(data, len(raw), "gpt4")
    assert torch.equal(f, pdp.successor_plain(data, len(raw), "gpt4"))
    for got, want in zip(pdp.presplit_orbit(f, len(raw)),
                         pdp.orbit_plain(f, len(raw))):
        assert torch.equal(got, want)
    for got, want in zip(pdp.presplit_cluster(data, len(raw), "gpt4"),
                         pdp.presplit_plain(data, len(raw), "gpt4")):
        assert torch.equal(got, want)
    assert kernels.PRESPLIT_SUCC.launches == 0
    assert kernels.PRESPLIT_ORBIT.launches == 0
    assert kernels.PRESPLIT_CLUSTER.launches == 0


@pytest.mark.parametrize("mode", MODES)
def test_mode_codes(mode):
    """A split given by its scanner code (regex.py's _split_mode, what the
    engine passes) is the split given by name."""
    raw = " | ".join(CASES).encode()
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    code = SCANNER[mode]
    assert pdp.mode_code(mode) == pdp.mode_code(code) == code
    for got, want in zip(pdp.presplit_seg_ids(data, len(raw), code),
                         pdp.presplit_seg_ids(data, len(raw), mode)):
        assert torch.equal(got, want)
    assert torch.equal(pdp.successor_plain(data, len(raw), code),
                       pdp.successor_plain(data, len(raw), mode))
    for other in (None, 0, 1, 3, "gpt3", "4", 4.5, [4]):
        assert pdp.mode_code(other) is None


# ---------------------------------------------------------------------------
# the CPU model of K15's tile steps (succ_tiles_model, orbit_tiles_model), at
# tiles of 8-64 bytes so that every text crosses many tiles
# ---------------------------------------------------------------------------

TILES = (8, 16, 64)
BLOCKS = (1, 3, 7)
# runs that cross dozens of 8-64-byte tiles, in text around them
LONG_RUNS = {
    "letters": lambda k: "x " + "a" * k + " b",
    "spaces": lambda k: "a" + " " * k + "b",
    "crlf": lambda k: "a" + "\r\n" * (k // 2) + " b",
    "digits": lambda k: "a " + "7" * k + "x",
    "apostrophes": lambda k: "a" + "'" * k + "s",
    "o_before_letters": lambda k: "a " + "!" * k + "abc d",
}


def _check_model(text: str, mode: str, tile: int):
    """The tile model's successors equal successor_plain's, and its orbit
    equals orbit_plain's and minbpe_tpu's split, at every grid in BLOCKS."""
    raw = text.encode("utf-8")
    n = len(raw)
    arr = _padded(raw)
    data = torch.from_numpy(arr)
    f = pdp.successor_plain(data, n, mode)
    pb, ps = pdp.orbit_plain(f, n)
    jb, js = (np.asarray(a)[:n] for a in jdp.presplit_seg_ids(arr, n, mode))
    for blocks in BLOCKS:
        assert torch.equal(pdp.succ_tiles_model(data, n, mode, tile, blocks),
                           f), (tile, blocks)
        mb, ms = pdp.orbit_tiles_model(f, n, tile, blocks)
        assert torch.equal(mb[:n], pb[:n]) and torch.equal(ms[:n], ps[:n])
        assert np.array_equal(mb.numpy()[:n], jb)
        assert np.array_equal(ms.numpy()[:n], js)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tile", TILES)
def test_tile_model_cases(mode, tile):
    for text in CASES:
        _check_model(text, mode, tile)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(4))
def test_tile_model_fuzz(mode, seed):
    rng = random.Random(100 + seed)
    alpha = ALPHA if seed < 2 else ALPHA_WIDE
    for length, tile in ((64, 8), (300, 16), (1500, 64), (1500, 8)):
        _check_model("".join(rng.choice(alpha) for _ in range(length)),
                     mode, tile)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", sorted(RUNS) + [
    f"long_{k}" for k in sorted(LONG_RUNS)])
def test_tile_model_runs(mode, kind):
    """Runs of 1,000 bytes: 15-125 tiles of one class."""
    make = (LONG_RUNS[kind[5:]] if kind.startswith("long_")
            else RUNS[kind])
    for tile in TILES:
        _check_model(make(1000), mode, tile)


@pytest.mark.parametrize("kind", sorted(LONG_RUNS))
def test_long_runs(kind):
    """The long runs through the split itself, in both modes, at 2^12 and
    2^14 bytes."""
    for mode in MODES:
        for log2 in (12, 14):
            _check(LONG_RUNS[kind](1 << log2), mode)


@pytest.mark.parametrize("seed", range(4))
def test_orbit_model_forward_jumps(seed):
    """The orbit model on any forward successor: random jumps up to 4
    tiles long and bytes off a char start (-1), so that walks seldom merge
    and a tile lists many exits; held to orbit_plain, with the node count
    that orbit_nodes gives."""
    rng = np.random.default_rng(seed)
    n = 3000
    f = np.arange(n) + 1 + rng.integers(0, 4 * 16 * (seed + 1), n)
    f[rng.random(n) < 0.2] = -1
    f[0] = max(f[0], 1)
    f = torch.from_numpy(np.r_[f, [-1] * 5].astype(np.int32))
    pb, ps = pdp.orbit_plain(f, n)
    tile = 16 * (seed + 1)
    for blocks in BLOCKS:
        stats = {}
        mb, ms = pdp.orbit_tiles_model(f, n, tile, blocks, stats=stats)
        assert torch.equal(mb[:n], pb[:n]) and torch.equal(ms[:n], ps[:n])
        assert stats["nodes"] == pdp.orbit_nodes(f, n, tile)
        assert stats["most_nodes"] > 2


def test_tile_model_stats():
    """On text the succ model's phase 1 stops in a block's first tile and
    each block looks right one round; the orbit lists about one node a
    tile, so its path takes the one-block tier."""
    text = golden.smoke_corpus(ROOT)[:60_000]
    raw = text.encode("utf-8")
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    n = len(raw)
    for mode in MODES:
        s_stats, o_stats = {}, {}
        f = pdp.succ_tiles_model(data, n, mode, 256, 16, s_stats)
        assert torch.equal(f, pdp.successor_plain(data, n, mode))
        pdp.orbit_tiles_model(f, n, 256, 16, stats=o_stats)
        assert s_stats["phase1_tiles_read"] == 16
        assert s_stats["lookright_rounds"] == 1
        assert o_stats["tiles"] <= o_stats["nodes"] <= 2 * o_stats["tiles"]
        assert o_stats["tier"] == "block"
        assert o_stats["nodes"] == pdp.orbit_nodes(f, n, 256)


# ---------------------------------------------------------------------------
# the CPU model of presplit_cluster (cluster_tiles_model): one cluster of up
# to 8 CTAs, a tile each, at tiles of 8-64 bytes
# ---------------------------------------------------------------------------

CLUSTER_TILES = (8, 16, 64)


def _check_cluster_model(text: str, mode: str, tile: int,
                         clusters=None) -> int:
    """The cluster model's successors equal successor_plain's, and its
    split equals orbit_plain's and minbpe_tpu's, on every cluster from the
    text's tiles to 8 (or ``clusters``); returns the path's hops."""
    raw = text.encode("utf-8")
    n = len(raw)
    tiles = -(-n // tile)
    assert tiles <= kernels.PRESPLIT_CLUSTER_MAX, (n, tile)
    arr = _padded(raw)
    data = torch.from_numpy(arr)
    f = pdp.successor_plain(data, n, mode)
    pb, ps = pdp.orbit_plain(f, n)
    jb, js = (np.asarray(a)[:n] for a in jdp.presplit_seg_ids(arr, n, mode))
    hops = 0
    for cluster in clusters or range(max(tiles, 1),
                                     kernels.PRESPLIT_CLUSTER_MAX + 1):
        stats = {}
        mb, ms = pdp.cluster_tiles_model(data, n, mode, tile, cluster, stats)
        if n:
            assert torch.equal(stats["f"], f), (tile, cluster)
            hops = stats["path_hops"]
        assert torch.equal(mb[:n], pb[:n]) and torch.equal(ms[:n], ps[:n])
        assert np.array_equal(mb.numpy()[:n], jb)
        assert np.array_equal(ms.numpy()[:n], js)
    return hops


def _fitting_tile(n: int) -> int:
    """The least of CLUSTER_TILES whose 8 tiles hold n bytes."""
    return next(t for t in CLUSTER_TILES
                if n <= kernels.PRESPLIT_CLUSTER_MAX * t)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tile", CLUSTER_TILES)
def test_cluster_model_cases(mode, tile):
    for text in CASES:
        if len(text.encode()) <= kernels.PRESPLIT_CLUSTER_MAX * tile:
            _check_cluster_model(text, mode, tile)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(4))
def test_cluster_model_fuzz(mode, seed):
    rng = random.Random(200 + seed)
    alpha = ALPHA if seed < 2 else ALPHA_WIDE
    for length in (30, 60, 250):
        text = "".join(rng.choice(alpha) for _ in range(length))
        _check_cluster_model(text, mode, _fitting_tile(len(text.encode())))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", sorted(RUNS) + [
    f"long_{k}" for k in sorted(LONG_RUNS)])
def test_cluster_model_runs(mode, kind):
    """Runs across every tile of the cluster: 100 bytes over 16-byte tiles
    and 480 over 64-byte ones."""
    make = (LONG_RUNS[kind[5:]] if kind.startswith("long_")
            else RUNS[kind])
    for k, tile in ((100, 16), (480, 64)):
        _check_cluster_model(make(k), mode, tile, clusters=(8,))


@pytest.mark.parametrize("mode", MODES)
def test_cluster_model_astral(mode):
    """4-byte chars across the edges of 8- and 16-byte tiles."""
    text = "𝕏𝐀 x🚀y '𐐀 1𝟙2 \U0001F600 😊😊"
    for tile in (8, 16):
        _check_cluster_model(text, mode, tile)
        _check_cluster_model("a" * (tile - 1) + "😊" * 10, mode, tile)


@pytest.mark.parametrize("cluster", range(1, 9))
def test_cluster_model_sizes(cluster):
    """Each cluster size on as many 64-byte tiles of the smoke corpus, in
    both modes: the path enters every tile that a chunk starts in."""
    raw = golden.smoke_corpus(ROOT).encode("utf-8")[:cluster * 64 - 3]
    text = raw.decode("utf-8", errors="ignore")
    for mode in MODES:
        hops = _check_cluster_model(text, mode, 64, clusters=(cluster,))
        assert hops == -(-len(text.encode()) // 64)


def test_cluster_model_limits():
    data = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError):
        pdp.cluster_tiles_model(data, 100, "gpt4", 8, 8)
    with pytest.raises(ValueError):
        pdp.cluster_tiles_model(data, 10, "gpt4", 8, 1)
    with pytest.raises(ValueError):
        pdp.cluster_tiles_model(data, 10, "gpt4", 8, 9)
    b, s = pdp.cluster_tiles_model(data, 0, "gpt4", 8, 1)
    assert not b.any() and (s == -1).all()


@pytest.mark.parametrize("n, tile, ctas", [
    (1, 512, 1), (512, 512, 1), (513, 512, 2), (1977, 512, 4),
    (4096, 512, 8), (4097, 1024, 5), (8192, 1024, 8), (8193, 2048, 5),
    (16384, 2048, 8), (16385, 4096, 5), (32768, 4096, 8)])
def test_cluster_geometry(n, tile, ctas):
    """presplit_cluster's tile is the least of 512-4,096 bytes whose 8 CTAs
    hold the text, and the text fills as many CTAs."""
    assert pdp.cluster_geometry(n) == (tile, ctas)
    with pytest.raises(ValueError):
        pdp.cluster_geometry(pdp.CLUSTER_MAX_N + 1)


def test_route_by_length():
    """K15's route is chosen by the stream's length alone: the cluster up
    to 8 tiles, the cooperative pair past them; on a CPU tensor
    presplit_cluster is the plain twin and refuses what the cluster
    cannot hold."""
    cap = kernels.PRESPLIT_CLUSTER_MAX * kernels.PRESPLIT_TILE
    assert pdp.CLUSTER_MAX_N == cap == 32768
    assert [pdp.route(n) for n in (0, 1, 4096, cap, cap + 1, 1 << 20)] == [
        "cluster"] * 4 + ["grid"] * 2
    raw = " | ".join(CASES).encode()
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    for got, want in zip(pdp.presplit_cluster(data, len(raw), "gpt4"),
                         pdp.presplit_plain(data, len(raw), "gpt4")):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="at most 32768"):
        pdp.presplit_cluster(torch.zeros(cap + 1, dtype=torch.uint8),
                             cap + 1, "gpt4")


# ---------------------------------------------------------------------------
# the token ids the split writes through a byte table (byte_ids)
# ---------------------------------------------------------------------------

def _byte_shuffle() -> np.ndarray:
    """A GPT4Tokenizer's byte shuffle: that of synthetic ranks."""
    return gpt4._forest_arrays(synthetic_ranks(300, seed=3)[0])[2]


BYTE_TABLES = {"identity": lambda: np.arange(256),
               "gpt4": _byte_shuffle}


def _ids_want(raw: bytes, table: str) -> np.ndarray:
    """Each byte's token id, by numpy on the host."""
    return BYTE_TABLES[table]()[np.frombuffer(raw, np.uint8)].astype(
        np.int32)


def _byte_ids(table: str):
    return torch.from_numpy(BYTE_TABLES[table]().astype(np.int32))


def _check_ids(text: str, mode: str, table: str, pad: int = 0):
    """presplit_seg_ids with the table: the ids are byte_ids[data], and the
    boundaries and segment ids those of the split without it."""
    raw = text.encode("utf-8")
    n = len(raw)
    data = torch.frombuffer(bytearray(raw + b"x" * pad), dtype=torch.uint8)
    byte_ids = _byte_ids(table)
    pb, ps = pdp.presplit_seg_ids(data, n, mode)
    got = pdp.presplit_seg_ids(data, n, mode, byte_ids)
    assert len(got) == 3
    gb, gs, ids = got
    assert ids.dtype == torch.int32 and ids.shape == (n + pad,)
    assert np.array_equal(ids.numpy()[:n], _ids_want(raw, table)), repr(text)
    assert torch.equal(gb, pb) and torch.equal(gs, ps)


@pytest.mark.parametrize("table", sorted(BYTE_TABLES))
@pytest.mark.parametrize("mode", MODES)
def test_ids_cases(table, mode):
    """CASES and lengths of 1-7 bytes, none a multiple of 4 among them,
    padded and not."""
    for text in CASES + ["a", "ab", "abc", "abcde", "😊x", "x😊", "é😊"]:
        _check_ids(text, mode, table)
    _check_ids(CASES[11], mode, table, pad=5)


@pytest.mark.parametrize("table", sorted(BYTE_TABLES))
@pytest.mark.parametrize("seed", range(2))
def test_ids_fuzz(table, seed):
    rng = random.Random(300 + seed)
    for length in (61, 298, 1501):
        text = "".join(rng.choice(ALPHA_WIDE) for _ in range(length))
        _check_ids(text, MODES[seed], table)


@pytest.mark.parametrize("cluster", range(1, 9))
def test_ids_cluster_model(cluster):
    """The cluster model with the table at each cluster size, 4-byte chars
    across the edges of its 16-byte tiles: the ids are byte_ids[data], the
    split that without the table."""
    byte_ids = _byte_ids("gpt4")
    raw = ("a" * 15 + "😊 𝕏'll" * 20).encode("utf-8")[:cluster * 16]
    raw = raw.decode("utf-8", errors="ignore").encode("utf-8")
    n = len(raw)
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    for mode in MODES:
        pb, ps = pdp.cluster_tiles_model(data, n, mode, 16, cluster)
        gb, gs, ids = pdp.cluster_tiles_model(data, n, mode, 16, cluster,
                                              byte_ids=byte_ids)
        assert torch.equal(gb, pb) and torch.equal(gs, ps)
        assert np.array_equal(ids.numpy()[:n], _ids_want(raw, "gpt4"))
        assert torch.equal(gb[:n], pdp.presplit_plain(data, n, mode)[0][:n])


def test_ids_wrappers_and_checks():
    """presplit_orbit and presplit_cluster take the table on the CPU too;
    a table of another dtype or size, or data without one, is refused."""
    raw = "Hello's world 123456 !!\r\n  x😊".encode()
    n = len(raw)
    data = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    byte_ids = _byte_ids("gpt4")
    want = _ids_want(raw, "gpt4")
    f = pdp.presplit_succ(data, n, "gpt4")
    ob, os_, ids = pdp.presplit_orbit(f, n, data, byte_ids)
    assert np.array_equal(ids.numpy(), want)
    pb, ps = pdp.presplit_orbit(f, n)
    assert torch.equal(ob, pb) and torch.equal(os_, ps)
    cb, cs, ids = pdp.presplit_cluster(data, n, "gpt4", byte_ids)
    assert np.array_equal(ids.numpy(), want)
    assert torch.equal(cb, pb) and torch.equal(cs, ps)
    b, s, ids = pdp.presplit_seg_ids(data[:0], 0, "gpt4", byte_ids)
    assert b.numel() == s.numel() == ids.numel() == 0
    for bad in (byte_ids.long(), byte_ids[:255],
                byte_ids.reshape(16, 16)):
        with pytest.raises((TypeError, ValueError)):
            pdp.presplit_seg_ids(data, n, "gpt4", bad)
    with pytest.raises(ValueError):
        pdp.presplit_orbit(f, n, data)
    with pytest.raises(ValueError):
        pdp.presplit_orbit(f, n, None, byte_ids)


# ---------------------------------------------------------------------------
# the opted-in encode
# ---------------------------------------------------------------------------

TEXT = golden.smoke_corpus(ROOT)[:24_000]
PATTERNS = {"gpt4": GPT4_SPLIT_PATTERN, "gpt2": GPT2_SPLIT_PATTERN}


def _pair(mode: str, vocab: int, special_tokens=None):
    """The port's and minbpe_tpu's RegexTokenizer with the smoke golden's
    first vocab - 256 merges."""
    merges = golden.load_golden()["merges"][:vocab - 256]
    p = tokenizer_from_arrays(port.RegexTokenizer, merges,
                              256 + np.arange(len(merges)),
                              pattern=PATTERNS[mode],
                              special_tokens=special_tokens, device="cpu")
    j = minbpe_tpu.RegexTokenizer(PATTERNS[mode])
    j.merges = dict(p.merges)
    j.vocab = j._build_vocab()
    if special_tokens:
        j.register_special_tokens(dict(special_tokens))
    return p, j


def _calls(monkeypatch):
    """A counter of the host scanner's calls."""
    calls = []
    real = native.split_offsets
    monkeypatch.setattr(native, "split_offsets",
                        lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("vocab", [300, 512, 1024])
def test_encode_device_split(mode, vocab, monkeypatch):
    p, j = _pair(mode, vocab)
    want = p.encode_ordinary(TEXT)
    assert want == j.encode_ordinary(TEXT)
    p.device_presplit = True
    calls = _calls(monkeypatch)
    assert p.encode_ordinary(TEXT) == want
    assert p.encode(TEXT) == want
    assert not calls
    assert p.decode(want) == TEXT


@pytest.mark.parametrize("mode", MODES)
def test_encode_device_split_specials(mode):
    """encode reaches the device split when no special is allowed; with
    specials, and in encode_batch, the host split stays, as in
    minbpe_tpu."""
    specials = {"<|a|>": 1100, "<|b|>": 1101}
    p, j = _pair(mode, 700, specials)
    p.device_presplit = True
    text = TEXT[:3000] + "<|a|>" + TEXT[3000:6000] + "<|b|>"
    for allowed in ("none", "all", {"<|b|>"}):
        assert p.encode(text, allowed_special=allowed) == j.encode(
            text, allowed_special=allowed)
    docs = [TEXT[:500], "", TEXT[500:4000]]
    assert p.encode_batch(docs) == [j.encode(d) for d in docs]


@pytest.mark.parametrize("case", ["cases", "runs"])
def test_encode_device_split_edges(case):
    p, j = _pair("gpt4", 600)
    p.device_presplit = True
    texts = (CASES if case == "cases"
             else [RUNS[k](3000) for k in sorted(RUNS)] + ["", "x"])
    for text in texts:
        assert p.encode_ordinary(text) == j.encode_ordinary(text), repr(text)


def test_gpt4_dense_synthetic_device_split(monkeypatch):
    """GPT4Tokenizer with a dense table: the split on the raw bytes, then
    the byte shuffle on the device (minbpe_tpu's device split skips it)."""
    ranks, _, specials = synthetic_ranks(1000, seed=3)
    p = port.GPT4Tokenizer.from_mergeable_ranks(ranks, specials,
                                                device="cpu")
    j = jgpt4.GPT4Tokenizer.from_mergeable_ranks(ranks, specials)
    assert engine.device_table(p).kind == "dense"
    assert not np.array_equal(p.byte_shuffle, np.arange(256))
    want = p.encode_ordinary(TEXT)
    assert want == j.encode_ordinary(TEXT)
    p.device_presplit = True
    calls = _calls(monkeypatch)
    got = p.encode_ordinary(TEXT)
    assert not calls
    assert got == want
    assert p.decode(got) == TEXT


def test_declines(tmp_path, monkeypatch):
    """None (the host split) for a custom pattern, a BasicTokenizer and a
    GPT-4 model loaded into RegexTokenizer(custom); a sorted table is
    taken (K17 reads its cuckoo rows as a dense table's) and gives the
    host split's ids."""
    custom = r"\w+|\s+|[^\w\s]+"
    merges = golden.load_golden()["merges"][:100]
    c = tokenizer_from_arrays(port.RegexTokenizer, merges,
                              256 + np.arange(100), pattern=custom,
                              device="cpu")
    b = tokenizer_from_arrays(port.BasicTokenizer, merges,
                              256 + np.arange(100), device="cpu")
    s = tokenizer_from_arrays(port.RegexTokenizer, [[97, 98]], [5000],
                              device="cpu")
    assert engine.device_table(s).kind == "sorted"
    g, _ = _pair("gpt4", 400)
    g.save(str(tmp_path / "g"))
    loaded = port.RegexTokenizer(custom, device="cpu")
    loaded.load(str(tmp_path / "g.model"))
    assert loaded.pattern == GPT4_SPLIT_PATTERN
    for tok in (c, b, loaded):
        tok.device_presplit = True
        assert engine.encode_text_device_split(tok, "hello world") is None
    want = s.encode_ordinary("abc ab ba")
    s.device_presplit = True
    assert engine.encode_text_device_split(s, "abc ab ba") == want
    assert 5000 in want
    g.device_presplit = False
    assert engine.encode_text_device_split(g, "hello world") is None
    # the loaded tokenizer keeps its constructor's split
    calls = _calls(monkeypatch)
    assert loaded.encode_ordinary(TEXT[:2000]) == tokenizer_from_arrays(
        port.RegexTokenizer, *g._merge_arrays(), pattern=custom,
        device="cpu").encode_ordinary(TEXT[:2000])
    assert not calls  # a custom pattern splits with regex, not the scanner


def test_device_split_limits(monkeypatch):
    p, _ = _pair("gpt4", 300)
    p.device_presplit = True
    assert p.encode_ordinary("") == []
    monkeypatch.setattr(pdp, "MAX_N", 10)
    with pytest.raises(ValueError, match="at most 10"):
        p.encode_ordinary("eleven byte")
    assert p.encode_ordinary("ten bytes!") == p.encode_batch(
        ["ten bytes!"])[0]
