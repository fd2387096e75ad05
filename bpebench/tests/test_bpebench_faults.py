"""``correct`` comes out true on a sound run, and false for the control
and for each fault a cell can have, with the timed path broken underneath.

Each run skips the harness's look for a card and drives the rest of a run
on the CPU, through the plain versions of the program's kernels, at a size
a test run holds (a small training text, a few short documents). The
faults: a training job that returns its state unchanged, a merge altered
where it is made; half of a request's ids left out, an id altered where it
is made. No cell spans chips, so there is no exchange between chips to
leave out.
"""

import time

import pytest

from bpebench import control, harness

SMALL = {"basic512-train-12m": {"min_bytes": 12_000, "block_lines": 64},
         "regex512-encode-docs": {"documents": 12, "strata": 4,
                                  "max_bytes": 2048}}
CELLS = sorted(SMALL)
SEEDS = (11, 2**31 + 5)


def _cell(name):
    cell = harness.load_cell(name)
    cell.traffic.update(SMALL[name])
    return cell


def _run(cell, seed, make_tokenizer=None):
    return harness.run_cell(cell, seed, 0.3, False, "cpu",
                            time.perf_counter(), make_tokenizer)


def _broken(cell, method, fault):
    """The program's tokenizer with ``method`` broken by ``fault``."""
    make = harness.program_tokenizer(cell.config, "cpu")

    def build():
        tok = make()
        sound = getattr(tok, method)
        setattr(tok, method, lambda *a: fault(tok, sound, *a))
        return tok

    return build


def _unchanged(tok, sound, text, vocab_size):
    pass


def _merge_altered(tok, sound, text, vocab_size):
    sound(text, vocab_size)
    (a, b), idx = max(tok.merges.items(), key=lambda kv: kv[1])
    del tok.merges[(a, b)]
    tok.merges[(b, a)] = idx


def _half_left_out(tok, sound, text):
    ids = sound(text)
    return ids[:len(ids) // 2]


def _id_altered(tok, sound, text):
    ids = sound(text)
    return ids[:-1] + [ids[-1] ^ 1]


FAULTS = {"train": [_unchanged, _merge_altered],
          "encode": [_half_left_out, _id_altered]}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(name, seed):
    out = _run(_cell(name), seed)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(name, seed):
    cell = _cell(name)
    out = _run(cell, seed, control.factory(cell.config, "cpu"))
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [0, 1])
def test_fault_is_not_correct(name, fault):
    cell = _cell(name)
    method = "train" if cell.traffic["kind"] == "train_jobs" else "encode"
    out = _run(cell, SEEDS[0],
               _broken(cell, method, FAULTS[method][fault]))
    assert not out["correct"], out["compared"]
