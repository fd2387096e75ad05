"""Sort-round training: every round counts all pairs of the live stream,
takes the reference's pair, applies it and compacts. No V-dependent memory
or work, so any vocab trains, and no count structure outlives a round.

The port's counterpart of minbpe_tpu/ops/train_sortloop.py (:49-190).
minbpe_tpu groups equal pairs with one stable ``lax.sort`` of (a, b,
position) a round: run lengths are the counts, run heads the first
occurrences, and the reference's pair is the largest count, then the
earliest first occurrence (minbpe/basic.py:35, base.py:20-21). Here a round
is three launches on the card, and nothing is read back to the host:
- K13 ``pair_select`` counts every pair, with its first position, into a
  device hash table (kernels.PairTable, sized once per run), takes the
  pair, writes the round's log row and the fail round under the gate
  fail >= i, and leaves the table empty; a round that finds no pair gives
  (-1, -1), which merges nowhere (ops/train_select.py does the same);
- K3 ``merge_apply`` applies it, left first, and K4 ``compact`` compacts.
On the CPU the three are their plain versions.

minbpe_tpu keeps the stream uncompacted, with tombstones, and finds each
token's next live neighbour and the left-first parity with blocked
select-scans over (R, 128) planes (``_pad_to_planes``, ops/scan2d.py),
because XLA's gathers serialise on the TPU. The port compacts after every
merge instead, as its other routes do, so a token's neighbours are the
adjacent positions: ops/scan2d.py is TPU layout and has no counterpart
here (its other user, the flat encoder, was ported without it too).

Two loops (ops/rounds.py): ``train_merges_sortloop`` (the whole run,
select_mode "sortloop_inc": the host reads the fail round once per
ROUNDS_PER_SYNC rounds) and ``train_merges_sortloop_stepped``
("sortloop", the route "auto" takes above vocab 2048, above 4·2^20 tokens
with a checkpoint or progress option, and above 48·2^20 tokens: steps of
``unroll`` rounds, the fail round read after each, with progress calls
and checkpoints at minbpe_tpu's rounds).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .rounds import RunLog, resume, run_rounds, stream
from .train import check_device_memory

UNROLL = 256
ROUNDS_PER_SYNC = 64
# device bytes per stream token at a round's peak: ids and seg (8), K3's
# merged ids and live mask (5), K4's compacted ids and seg (8), and the
# caller's stream (8); the table's slots come on top
BYTES_PER_TOKEN = 29


def device_bytes(n_tokens: int) -> int:
    return (BYTES_PER_TOKEN * n_tokens
            + kernels.PairTable.device_bytes(n_tokens))


class _State(RunLog):
    """The compacted stream, the table and the run's log, on the stream's
    device: sel = (pa, pb, count, ok) of the last round."""

    def __init__(self, ids, seg, n, M: int):
        super().__init__(M, ids.device)
        self.ids, self.seg, self.n = ids, seg, n
        self.table = kernels.PairTable(ids.numel(), ids.device)
        self.sel = torch.zeros(4, dtype=torch.int32, device=ids.device)


def _round(st: _State, i: int):
    """Merge round i (minbpe_tpu/ops/train_sortloop.py:49-103)."""
    kernels.pair_select(st.ids, st.seg, st.n, st.table, st.sel, st.pairs,
                        st.cnts, st.fail, i)
    merged, live = kernels.merge_apply(st.ids, st.seg, st.n, st.sel,
                                       256 + i)
    st.ids, st.seg, st.n = kernels.compact(merged, st.seg, live, st.n)


def _check(ids, num_merges: int):
    if ids.is_cuda:
        N = ids.numel()
        check_device_memory(ids.device, device_bytes(N),
                            f"the sort-round trainer on {N} tokens "
                            f"({BYTES_PER_TOKEN} B/token and "
                            f"{kernels.PairTable.BYTES_PER_SLOT} B per "
                            "table slot)")


def train_merges_sortloop(ids, seg, num_merges: int):
    """The whole run. Same contract as ops.train.train_merges: numpy
    (pairs[M, 2], counts[M]) and the fail round (M when every round found
    a pair; rows from it on are zero)."""
    M = num_merges
    if M == 0 or ids.numel() < 2:  # nothing to learn, or no pair at all
        return np.zeros((M, 2), np.int32), np.zeros((M,), np.int32), 0
    _check(ids, M)
    return run_rounds(_State(*stream(ids, seg), M), _round,
                      unroll=ROUNDS_PER_SYNC, steps_per_sync=1)


def train_merges_sortloop_stepped(ids, seg, num_merges: int,
                                  unroll: int = UNROLL,
                                  checkpoint_path: str | None = None,
                                  checkpoint_every: int | None = None,
                                  resume_from: str | None = None,
                                  progress=None,
                                  fingerprint: str | None = None):
    """Steps of ``unroll`` rounds; bit-identical to train_merges_sortloop,
    with progress calls, checkpoints and resume as ops/rounds.run_rounds
    and resume make them (minbpe_tpu's rounds and order, :176-190)."""
    _check(ids, num_merges)
    ids, seg, n, prefix = resume(ids, seg, num_merges, resume_from,
                                 checkpoint_path, fingerprint)
    return run_rounds(_State(ids, seg, n, num_merges), _round, unroll=unroll,
                      steps_per_sync=1, prefix=prefix, progress=progress,
                      checkpoint_path=checkpoint_path,
                      checkpoint_every=checkpoint_every,
                      fingerprint=fingerprint)
