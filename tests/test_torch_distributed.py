"""The port's distributed layer (minbpe_tpu_torch.parallel) against
minbpe_tpu.parallel on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices that
conftest.py sets, through make_mesh(D). The port side runs D gloo ranks,
D in {1, 2, 4}, from a pool of four processes spawned once for the module
(torch_dist_pool.py: each job has its own time limit and the group a
timeout). The same inputs go to both, and the merges, their counts, the
fail round, the overflow errors, the checkpoints and the encoded ids must
be equal. Both sides are exact, so a port result at world D is also held
to the JAX result at another D where one compile serves several cases.
"""

import random

import numpy as np
import pytest
import torch

import oracle
import torch_dist_pool as jobs
from minbpe_tpu.parallel import train as jt
from minbpe_tpu.parallel.encode import encode_chunks_distributed as jax_enc
from minbpe_tpu.utils import checkpoint as jck
from minbpe_tpu_torch import kernels
from minbpe_tpu_torch.parallel import comm as pcomm
from minbpe_tpu_torch.parallel import multihost
from minbpe_tpu_torch.parallel import train as pt
from minbpe_tpu_torch.utils import checkpoint as pck

torch.set_num_threads(1)
WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def pool():
    p = jobs.Pool()
    yield p
    p.close()


def _jax(fn, *args, **kw):
    """The JAX result, or the ValueError / RuntimeError it raises."""
    try:
        return fn(*args, **kw)[0]
    except (ValueError, RuntimeError) as e:
        return e


def _port(pool, fn, world, *args, **kw):
    try:
        res = pool.run(fn, world, *args, **kw)
    except (ValueError, RuntimeError) as e:
        return e
    assert all(r == res[0] for r in res), "ranks disagree"
    return res[0]


def _same(got, want):
    if isinstance(want, Exception):
        assert type(got) is type(want) and str(got) == str(want), got
    else:
        assert got == want


def _random_chunks(seed, lo=97, hi=104, n_max=40, len_max=24):
    rng = random.Random(seed)
    return [bytes(rng.randint(lo, hi) for _ in range(rng.randint(1, len_max)))
            for _ in range(rng.randint(2, n_max))], rng


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

LAYOUTS = {
    "five": [b"abc", b"de", b"f", b"ghij", b"kl"],
    "empty_chunks": [b"", b"ab", b"", b"", b"cdefgh", b"", b"i", b""],
    "one_long": [b"x" * 1000, b"y", b"z" * 3],
    "none": [],
    "all_empty": [b"", b""],
    "random": _random_chunks(5, n_max=300, len_max=60)[0],
}


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_shard_chunks_equal_jax(name, D):
    chunks = LAYOUTS[name]
    for got, want in zip(pt.shard_chunks(chunks, D),
                         jt.shard_chunks(chunks, D)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [0, 1, 7, 128, 1000, 4097])
def test_shard_bytes_equal_jax(n, D):
    data = bytes(random.Random(n).randrange(256) for _ in range(n))
    for got, want in zip(pt.shard_bytes(data, D), jt.shard_bytes(data, D)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_positions_must_fit_int32():
    pt.check_positions(2, 1 << 29)
    with pytest.raises(ValueError, match="2\\^31"):
        pt.check_positions(4, 1 << 29)


# ---------------------------------------------------------------------------
# the kernels' plain versions against JAX's round pieces
# ---------------------------------------------------------------------------

def _extended(rng, Nl=128, alphabet=3, halo=True):
    """A compacted shard (ids, seg over Nl, n) and its halo."""
    n = int(rng.integers(0, Nl + 1))
    ids = np.full(Nl, -1, np.int32)
    seg = np.full(Nl, -1, np.int32)
    ids[:n] = rng.integers(97, 97 + alphabet, n)
    seg[:n] = np.cumsum(rng.random(n) < 0.05)
    hid, hseg = int(rng.integers(97, 97 + alphabet)), int(seg[max(n - 1, 0)])
    if rng.random() < 0.3:
        hseg += 1
    return ids, seg, n, hid, hseg, bool(halo and n > 0)


def _port_ext(ids, seg, n, hid, hseg, ok):
    """The port's extended stream: the shard, the halo token at index n."""
    e_ids = np.append(ids, -1).astype(np.int32)
    e_seg = np.append(seg, -1).astype(np.int32)
    e_ids[n], e_seg[n] = hid, hseg
    return (torch.from_numpy(e_ids), torch.from_numpy(e_seg),
            torch.tensor([n + int(ok)], dtype=torch.int32))


@pytest.mark.parametrize("seed", range(12))
def test_pair_summaries_plain_equal_local_run_summaries(seed):
    """pair_summaries_plain's rows as a map pair -> (count, position) equal
    JAX's _local_run_summaries on the same shard (no tombstones), with its
    overflow at a small K."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    ids, seg, n, hid, hseg, ok = _extended(rng, alphabet=2 + seed % 5,
                                           halo=seed % 3 != 0)
    base = 128 * (seed % 4)
    live = np.arange(128) < n
    a, b, pok = jt._pair_arrays(jnp.asarray(ids), jnp.asarray(seg),
                                jnp.asarray(live), hid, hseg, ok)
    for K in (129, 6):
        pa, pb, cnt, pos, of = (np.asarray(x) for x in
                                jt._local_run_summaries(a, b, pok, base, K))
        want = {(int(x), int(y)): (int(c), int(p))
                for x, y, c, p in zip(pa, pb, cnt, pos) if c > 0}
        out = torch.zeros((K, 4), dtype=torch.int32)
        used = torch.zeros(1, dtype=torch.int32)
        over = torch.zeros(1, dtype=torch.int32)
        kernels.pair_summaries_plain(*_port_ext(ids, seg, n, hid, hseg, ok),
                                     None, base, out, used, over)
        got = {(int(x), int(y)): (int(c), int(p))
               for x, y, c, p in out[:int(used)].tolist()}
        assert int(over) == int(of)
        if not int(of):
            assert got == want


@pytest.mark.parametrize("seed", range(16))
def test_carry_in_equal_extended_keep(seed):
    """K3's plain carry-in and the transfer bits equal JAX's
    _extended_keep: the keep masks at carry-in 0 and 1, and (co0, co1)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(100 + seed)
    ids, seg, n, hid, hseg, ok = _extended(rng, alphabet=1 + seed % 3,
                                           halo=seed % 4 != 0)
    if seed % 5 == 0:  # one run of a single id through the halo
        ids[:n], seg[:n], hid, hseg = 97, 0, 97, 0
    live = np.arange(128) < n
    a, b, _ = jt._pair_arrays(jnp.asarray(ids), jnp.asarray(seg),
                              jnp.asarray(live), hid, hseg, ok)
    e_ids, e_seg, n_ext = _port_ext(ids, seg, n, hid, hseg, ok)
    for pa, pb in ((97, 97), (97, 98), (98, 97)):
        k0, k1, co0, co1 = (np.asarray(x) for x in
                            jt._extended_keep(a, b, jnp.asarray(live), pa, pb))
        pair = torch.tensor([pa, pb], dtype=torch.int32)
        tf = torch.zeros(2, dtype=torch.int32)
        for start, keep in ((0, k0), (1, k1)):
            t = torch.zeros(2, dtype=torch.int32)
            out, _ = kernels.merge_apply(
                e_ids, e_seg, n_ext, pair, 999,
                carry=torch.tensor([start], dtype=torch.int32), tf=t)
            assert np.array_equal(out[:n].numpy() == 999, keep[:n])
            if start == 0:
                tf = t
        bits = pt.transfer_bits(tf, torch.tensor(ok),
                                torch.tensor([n], dtype=torch.int32))
        assert bits.tolist() == [int(co0), int(co1)]


# ---------------------------------------------------------------------------
# training against minbpe_tpu.parallel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_random_chunks_equal_jax(pool, seed):
    """test_distributed.py's random chunk lists: equal merges, or the
    ValueError at the same fail round, at every world size."""
    chunks, rng = _random_chunks(seed)
    M = rng.randint(1, 10)
    D = WORLDS[seed % 3]
    want = _jax(jt.train_chunks_distributed, chunks, M, jt.make_mesh(D))
    if not isinstance(want, Exception):
        assert want == dict(oracle.train(chunks, M))
    for world in WORLDS:
        _same(_port(pool, jobs.train_chunks, world, chunks, M), want)


@pytest.mark.parametrize("seed", range(8))
def test_basic_halo_equal_jax(pool, seed):
    """test_distributed.py's Basic halo cases: pairs across shards and runs
    across them, counted and merged with the global parity."""
    rng = random.Random(1000 + seed)
    data = bytes(rng.choice([rng.randint(97, 99), 97])
                 for _ in range(rng.randint(16, 300)))
    M = rng.randint(1, 8)
    D = WORLDS[seed % 3]
    want = _jax(jt.train_bytes_distributed, data, M, jt.make_mesh(D))
    for world in WORLDS:
        _same(_port(pool, jobs.train_bytes, world, data, M), want)


@pytest.mark.parametrize("n, M", [(131, 4), (4, 3), (2, 1), (1, 1)])
def test_single_byte_runs_across_shards(pool, n, M):
    """One run of "a" across every shard boundary, and shards left empty
    (n below the world size): the identity carry of an empty shard."""
    data = b"a" * n
    want = _jax(jt.train_bytes_distributed, data, M, jt.make_mesh(4))
    for world in WORLDS:
        _same(_port(pool, jobs.train_bytes, world, data, M), want)


@pytest.mark.parametrize("seed", range(5))
def test_selections_equal_each_other_and_jax(pool, seed):
    """dense, sparse and owner: equal to one another and to JAX's owner
    selection at the same world size (test_distributed.py's sparse and
    owner cases)."""
    chunks, rng = _random_chunks(2000 + seed, 97, 106, 40, 30)
    M = rng.randint(2, 10)
    world = WORLDS[seed % 3]
    want = _jax(jt.train_chunks_distributed, chunks, M,
                jt.make_mesh(world), selection="owner")
    for sel in pt.SELECTIONS:
        _same(_port(pool, jobs.train_chunks, world, chunks, M,
                    selection=sel), want)


@pytest.mark.parametrize("world", WORLDS)
def test_text_equal_jax_and_single_device(pool, world):
    """A text through the GPT-4 split at vocab 256 + 40 by each selection:
    equal to JAX's and to the port's single-device RegexTokenizer."""
    from minbpe_tpu_torch import RegexTokenizer

    text = ("Distributed byte pair encoding must agree exactly with the "
            "single device path, ties and all. " * 30)
    single = RegexTokenizer(device="cpu")
    single.train(text, 256 + 40)
    for sel in pt.SELECTIONS:
        assert _port(pool, jobs.train_offsets, world, text, 40,
                     selection=sel) == single.merges
    chunks = single._split_arrays(text)
    data, ends = chunks
    pieces = [bytes(data[a:b]) for a, b in zip(np.r_[0, ends[:-1]], ends)]
    assert jt.train_chunks_distributed(pieces, 40, jt.make_mesh(world),
                                       selection="sparse")[0] == \
        single.merges


def _overflow_inputs(D):
    rng = random.Random(1)
    chunks = [bytes(rng.randint(0, 255) for _ in range(64))
              for _ in range(16)]
    return pt.shard_chunks(chunks, D)


@pytest.mark.parametrize("selection, cap", [("sparse", {"sparse_cap": 4}),
                                            ("owner", {"owner_cap": 1})])
def test_overflow_at_jax_caps(pool, selection, cap):
    """test_distributed.py's overflow settings: the flag on every rank at
    world 4, as JAX's at D = 4, and the RuntimeError through the entry
    point; none at the default caps."""
    ids, seg, lens = _overflow_inputs(4)
    Nl = ids.shape[0] // 4
    fn = jt.build_distributed_train(jt.make_mesh(4), 2, 258, Nl,
                                    selection=selection, **cap)
    _, _, _, want = fn(ids, seg, lens)
    assert int(want) == 1
    res = pool.run(jobs.train_arrays, 4, ids, seg, lens, 2,
                   selection=selection, **cap)
    assert [r[3] for r in res] == [1] * 4
    res = pool.run(jobs.train_arrays, 4, ids, seg, lens, 2,
                   selection=selection)
    assert [r[3] for r in res] == [0] * 4
    assert all(np.array_equal(r[0], res[0][0]) for r in res)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        pt._finish_train(*res[0][:3], 2, False, 1)


def test_unknown_selection_raises(pool):
    with pytest.raises(ValueError, match="unknown selection"):
        pool.run(jobs.train_chunks, 2, [b"abab"], 1, selection="topk")


# ---------------------------------------------------------------------------
# stepped training and checkpoints
# ---------------------------------------------------------------------------

def test_stepped_equal_whole_run(pool):
    from minbpe_tpu_torch import RegexTokenizer

    text = ("Stepped distributed training must match the one-launch "
            "program exactly, ties included. " * 40)
    single = RegexTokenizer(device="cpu")
    single.train(text, 256 + 30)
    for world in WORLDS:
        for sel in ("dense", "owner"):
            assert _port(pool, jobs.train_offsets, world, text, 30,
                         selection=sel, checkpoint_every=7) == single.merges


def _kill_chunks():
    rng = random.Random(77)
    return [bytes(rng.randint(97, 105) for _ in range(rng.randint(1, 20)))
            for _ in range(60)]


def _cut(path, rounds, ck):
    """Rewrite a checkpoint back to its first ``rounds`` rounds, as if the
    run had been killed then."""
    state = ck.load(path)
    assert state["round_idx"] >= rounds
    ck.save(path, state["pairs"][:rounds], state["counts"][:rounds], rounds,
            state["num_merges"], state["fingerprint"])


def test_kill_and_resume(pool, tmp_path):
    chunks, M = _kill_chunks(), 26
    full = dict(oracle.train(chunks, M))
    for world in WORLDS:
        path = str(tmp_path / f"w{world}.npz")
        assert _port(pool, jobs.train_chunks, world, chunks, M,
                     checkpoint_path=path, checkpoint_every=8) == full
        _cut(path, 8, pck)
        got = _port(pool, jobs.train_chunks, world, chunks, M,
                    checkpoint_path=str(tmp_path / f"r{world}.npz"),
                    checkpoint_every=8, resume_from=path)
        assert got == full


def test_checkpoints_cross_packages(pool, tmp_path):
    """A checkpoint minbpe_tpu's stepped trainer wrote at D = 4 resumes in
    the port at world 4, and the port's resumes in minbpe_tpu."""
    chunks, M = _kill_chunks(), 26
    full = dict(oracle.train(chunks, M))
    mesh = jt.make_mesh(4)
    ids, seg, lens = jt.shard_chunks(chunks, 4)
    jpath = str(tmp_path / "jax.npz")
    jt._train_distributed_stepped(ids, seg, lens, M, mesh, False, "dense",
                                  jpath, 8, None)
    _cut(jpath, 16, jck)
    assert _port(pool, jobs.train_chunks, 4, chunks, M, checkpoint_every=8,
                 resume_from=jpath) == full
    ppath = str(tmp_path / "port.npz")
    assert _port(pool, jobs.train_chunks, 4, chunks, M,
                 checkpoint_path=ppath, checkpoint_every=8) == full
    _cut(ppath, 8, pck)
    assert jt.train_chunks_distributed(chunks, M, mesh, checkpoint_every=8,
                                       resume_from=ppath)[0] == full


def test_resume_wrong_corpus_rejected(pool, tmp_path):
    rng = random.Random(78)
    chunks = [bytes(rng.randint(97, 103) for _ in range(12))
              for _ in range(40)]
    path = str(tmp_path / "c.npz")
    pool.run(jobs.train_chunks, 2, chunks, 10, checkpoint_path=path,
             checkpoint_every=4)
    other = [b"different corpus entirely"] * 40
    with pytest.raises(ValueError, match="fingerprint|corpus"):
        pool.run(jobs.train_chunks, 2, other, 10, resume_from=path)
    with pytest.raises(ValueError, match="different vocab"):
        pool.run(jobs.train_chunks, 2, chunks, 12, resume_from=path)


# ---------------------------------------------------------------------------
# the sharded encode
# ---------------------------------------------------------------------------

def _regex_table(text, vocab):
    from minbpe_tpu_torch import RegexTokenizer

    tok = RegexTokenizer(device="cpu")
    tok.train(text, vocab)
    return tok._merge_arrays()


@pytest.mark.parametrize("world", WORLDS)
def test_encode_equal_jax_and_encode_ordinary(pool, world):
    text = ("Sharded encode is the sequence-parallel serving path; "
            "chunks are independent so exactness is free! " * 50)
    pairs, new_ids = _regex_table(text, 256 + 40)
    got, ordinary = pool.run(jobs.encode_text, world, "regex",
                             (pairs, new_ids), text)[0]
    assert got == ordinary
    from minbpe_tpu_torch import RegexTokenizer

    chunks = RegexTokenizer(device="cpu")._split_arrays(text)
    data, ends = chunks
    pieces = [bytes(data[a:b]) for a, b in zip(np.r_[0, ends[:-1]], ends)]
    want = jax_enc(pieces, pairs, new_ids, mesh=jt.make_mesh(world))
    assert got == want.tolist()
    port = pool.run(jobs.encode_chunks, world, pieces, pairs, new_ids)
    assert all(np.array_equal(r, want) for r in port)


def test_encode_empty_and_no_merges(pool):
    empty = (np.zeros((0, 2), np.int32), np.zeros(0, np.int32))
    for world in WORLDS:
        assert pool.run(jobs.encode_text, world, "regex", empty, "")[0] == \
            ([], [])
        got, ordinary = pool.run(jobs.encode_text, world, "regex", empty,
                                 "hi there")[0]
        assert got == ordinary == list(b"hi there")
        assert pool.run(jobs.encode_chunks, world, [], *empty)[0].size == 0


def test_encode_gpt4_dense_table(pool):
    """GPT4Tokenizer with a dense synthetic table: the byte shuffle goes
    through, so the sharded encode equals the port's single-device
    encode_ordinary (minbpe_tpu's skips the shuffle)."""
    from minbpe_tpu_torch.utils.synthranks import synthetic_ranks

    ranks = synthetic_ranks(1000, seed=7)[0]
    text = ("GPT-4 style ranks through the sharded encode: ünïcödé, "
            "digits 12345 and   spaces.\n" * 20)
    for world in WORLDS:
        got, ordinary = pool.run(jobs.encode_text, world, "gpt4", ranks,
                                 text)[0]
        assert got == ordinary


def test_encode_refuses_a_sorted_table(pool):
    from minbpe_tpu_torch.utils.synthranks import synthetic_ranks

    ranks = synthetic_ranks(4353, seed=1)[0]
    with pytest.raises(ValueError, match="dense table"):
        pool.run(jobs.encode_text, 2, "gpt4", ranks, "some text")


# ---------------------------------------------------------------------------
# multihost
# ---------------------------------------------------------------------------

def test_local_feeding_equal_replicated(pool):
    """test_driver_entry.py's case: each rank feeding its own slice gives
    the replicated run's merges (and JAX's)."""
    words = (b"the cat sat on the mat and the cat sat on that hat "
             b"while the rat sat flat").split()
    chunks = [b" " + w for w in words] * 3
    want = jt.train_chunks_distributed(chunks, 12, jt.make_mesh(4))[0]
    for world in WORLDS:
        assert _port(pool, jobs.train_global, world, chunks, 12) == want
        for sel in ("dense", "sparse"):
            assert _port(pool, jobs.train_local, world, chunks, 12,
                         sel) == want


def test_collectives(pool):
    res = pool.run(jobs.collectives, 4)
    for r, out in enumerate(res):
        assert out["sum"] == [10, 34] and out["min"] == [1, 7]
        assert out["max"] == [4, 10]
        assert out["gather"] == [[k + 1, 10 - k] for k in range(4)]
        assert out["to_all"] == [[100 * j + 2 * r, 100 * j + 2 * r + 1]
                                 for j in range(4)]
        assert out["bcast"] == [4, 7]
        assert out["varlen"] == [10 * j + k for j in range(4)
                                 for k in range(j)]
        assert out["calls"] == 8
        assert out["spans"] == {
            "minbpe.comm.sum": 1, "minbpe.comm.min": 1, "minbpe.comm.max": 1,
            "minbpe.comm.all_gather": 3, "minbpe.comm.all_to_all": 1,
            "minbpe.comm.broadcast": 1}


def test_initialize_reraises_real_failures(monkeypatch):
    import torch.distributed as dist

    def boom(**kwargs):
        raise RuntimeError("master unreachable at 10.0.0.1:1234")

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="master unreachable"):
        multihost.initialize(backend="gloo")

    def already(**kwargs):
        raise RuntimeError("process group already initialized")

    monkeypatch.setattr(dist, "init_process_group", already)
    multihost.initialize(backend="gloo")  # benign


def test_entry_points_need_a_process_group():
    """No quiet single-process run: this process has no group."""
    with pytest.raises(RuntimeError, match="no process group"):
        pt.train_chunks_distributed([b"abab"], 1, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        multihost.global_group()
    with pytest.raises(RuntimeError, match="no process group"):
        pcomm.Comm(device="cpu")
