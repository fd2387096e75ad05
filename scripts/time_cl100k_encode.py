#!/usr/bin/env python3
"""K17 segment_encode at cl100k's width on one NVIDIA GPU, beside the same
kernel with the 256-merge table, and the GPT-4 encode's wall time with the
device split and with the host split.

    python3 scripts/time_cl100k_encode.py [--docs 256] [--reps 20]

The table is the cl100k-encode-docs cell's (bpebench/configs-ranks/
gpt4-cl100k.json: the 100,256-rank stand-in, its cuckoo table 2^18 rows a
table, 8 MB); the other is regex512-encode-docs' (256 merges, 512 rows a
table). The documents are the encode cells' (``chip_smoke.cell_documents``:
the traffic's lengths from starts that a fixed seed picks), each split on
the card (K15, which writes the ids through the byte shuffle, or the
identity for the 256-merge table) into the stream the encoder gets. For
the median document, one of the mean length, the longest (32,768 bytes)
and the whole smoke corpus it reports K15's device ms (with the
shuffle), K17's with either table
(``chip_smoke.device_ms``), the tokens out, K17's bytes bound at 3.35 TB/s
(8 B read a token, 8 B written an output token) and the median host ms of
``GPT4Tokenizer.encode`` with the device split and with the host split
(K11/K12); the same for one chunk of 2,048, 8,192 and 65,536 seeded
lowercase letters (``letters_<n>``: a word the GPT-4 split keeps whole,
which K17 gives to one block, round after round, where the host split
gives it to K12); then, over the first ``--docs`` documents, K17's summed
ms with either table and its ms a MB of text. K17's ids must equal the host
split's for every document. It prints a JSON object a shape, one for the
whole, then the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

CONFIG = os.path.join("bpebench", "configs-ranks", "gpt4-cl100k.json")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return chip_smoke.fail("CUDA is not available")
    from minbpe_tpu_torch import GPT4Tokenizer, RegexTokenizer, engine
    from minbpe_tpu_torch import kernels
    from minbpe_tpu_torch.gpt4 import GPT4_SPECIAL_TOKENS, load_cl100k_ranks
    from minbpe_tpu_torch.ops import device_presplit as pdp

    kernels.build()
    with open(os.path.join(ROOT, CONFIG)) as f:
        config = json.load(f)
    t0 = time.perf_counter()
    ranks = load_cl100k_ranks(os.path.join(ROOT, config["ranks"]))
    gpt, host = (GPT4Tokenizer.from_mergeable_ranks(
        ranks, GPT4_SPECIAL_TOKENS, device="cuda") for _ in range(2))
    build_s = time.perf_counter() - t0
    gpt.device_presplit = True
    small = RegexTokenizer(device="cuda")
    small.load(os.path.join(ROOT, chip_smoke.CELL_MODEL))
    cl100k, v512 = (engine.device_table(t).cuckoo for t in (gpt, small))
    shuffle, identity = (engine.device_table(t).byte_ids
                         for t in (gpt, small))
    data, lengths, starts = chip_smoke.cell_documents(
        np, chip_smoke.CELL_SEED)

    def stream(raw: bytes):
        """The bytes on the card, and K15's segment ids and ids through
        the byte shuffle and through the identity."""
        d = torch.frombuffer(bytearray(raw), dtype=torch.uint8).cuda()
        _, seg, ids = pdp.presplit_seg_ids(d, len(raw), 4, shuffle)
        plain = pdp.presplit_seg_ids(d, len(raw), 4, identity)[2]
        return d, seg, ids, plain

    def wall_ms(tok, text, reps):
        walls = []
        for _ in range(reps):
            t = time.perf_counter()
            tok.encode(text, allowed_special="none")
            walls.append((time.perf_counter() - t) * 1e3)
        return statistics.median(walls)

    def shape(name, raw: bytes, reps: int):
        d, seg, ids, plain = stream(raw)
        out = kernels.segment_encode(ids, seg, cl100k)
        k = int(out[2])
        text = raw.decode("utf-8")
        if out[0][:k].tolist() != host.encode(text, allowed_special="none"):
            raise AssertionError(f"{name}: K17 differs from the host split")
        n = ids.numel()
        rec = dict(
            case=name, bytes=len(raw), tokens_out=k,
            k15_ms=chip_smoke.device_ms(
                torch, lambda: pdp.presplit_seg_ids(d, len(raw), 4, shuffle),
                reps),
            k17_cl100k_ms=chip_smoke.device_ms(
                torch, lambda: kernels.segment_encode(ids, seg, cl100k),
                reps),
            k17_v512_ms=chip_smoke.device_ms(
                torch, lambda: kernels.segment_encode(plain, seg, v512),
                reps),
            k17_bound_ms=(8 * n + 8 * k) / chip_smoke.HBM_BYTES_PER_S * 1e3,
            wall_device_split_ms=wall_ms(gpt, text, reps),
            wall_host_split_ms=wall_ms(host, text, reps))
        print(json.dumps(rec))
        return rec

    cases = [shape(name, raw, args.reps)
             for name, raw in chip_smoke.cell_shapes(np, data, lengths,
                                                     starts)]
    cases.append(shape("smoke_corpus", data, 5))
    rng = np.random.default_rng(0)
    for n in (2048, 8192, 65536):
        word = rng.integers(ord("a"), ord("z") + 1, n, dtype=np.uint8)
        cases.append(shape(f"letters_{n}", word.tobytes(), 5))
    sums = {"cl100k": 0.0, "v512": 0.0}
    total = out_tokens = 0
    for i in range(min(args.docs, len(lengths))):
        raw = data[starts[i]:starts[i] + lengths[i]]
        d, seg, ids, plain = stream(raw)
        out = kernels.segment_encode(ids, seg, cl100k)
        k = int(out[2])
        want = host.encode(raw.decode("utf-8"), allowed_special="none")
        if out[0][:k].tolist() != want:
            raise AssertionError(f"document {i}: K17 differs from the host "
                                 "split")
        sums["cl100k"] += chip_smoke.device_ms(
            torch, lambda: kernels.segment_encode(ids, seg, cl100k), 10)
        sums["v512"] += chip_smoke.device_ms(
            torch, lambda: kernels.segment_encode(plain, seg, v512), 10)
        total += len(raw)
        out_tokens += k
    print(json.dumps(dict(
        cases=cases, tokenizer_build_s=build_s,
        cuckoo_rows=dict(cl100k=cl100k.H, v512=v512.H),
        documents=min(args.docs, len(lengths)), document_bytes=total,
        tokens_out=out_tokens,
        k17_ms_per_MB={k: v / (total / 1e6) for k, v in sums.items()},
        retaken=len(chip_smoke.RETAKEN_READINGS))))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
