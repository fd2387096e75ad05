#!/usr/bin/env python3
"""K17 segment_encode against K10 encode_sweep on one NVIDIA GPU: at the
regex512-encode-docs cell's shapes, and on streams with segments past
CHUNK_MAX tokens, which K17 gives to one block (the route,
ops/encode.short_segments, keeps K10 past TILE tokens).

    python3 scripts/time_segment_encode.py [--docs 256] [--reps 20]

The cell's table (bpebench/data/minbpe-regex-v512.model: 256 merges, the
GPT-4 split) and documents (``chip_smoke.cell_documents``: the traffic's
lengths from starts that a fixed seed picks), each split on the card (K15,
which writes the ids through the table's byte ids) into the stream that
``engine.encode_text_device_split`` hands the encoder. For the median
document, one of the mean length, the longest (32,768 bytes) and the
whole smoke corpus it reports K17's and K10's
device ms (``chip_smoke.device_ms``: CUDA events behind a sleeping
kernel), K17's bytes bound at 3.35 TB/s (8 B read a token, 8 B written an
output token) and the plain twin's ms on the CPU; then, over the first
``--docs`` documents, each kernel's summed ms a document and its ms a MB
of text. Then the host-split streams with long segments, each with the
route the host chooses: BasicTokenizer.encode_batch's stream (a document a
segment, bpebench/data/minbpe-basic-v512.model) of 2 and 4 documents of
64 KB and of 1 MB; a RegexTokenizer text (the cell's table) whose split
holds a chunk of 70,000 tokens; and the smoke corpus's first 20,000 bytes
split, with one segment of 257 to 65,536 corpus bytes after them. K17's
output must equal K10's everywhere. It prints a JSON object a shape, one
for the whole, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

LONG = (257, 512, 1024, 2048, 4096, 16_384, 65_536)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return chip_smoke.fail("CUDA is not available")
    from minbpe_tpu_torch import BasicTokenizer, RegexTokenizer, engine
    from minbpe_tpu_torch import kernels
    from minbpe_tpu_torch.ops import device_presplit as pdp
    from minbpe_tpu_torch.ops.encode import short_segments
    from minbpe_tpu_torch.ops.ranktab import CuckooPairTable
    from minbpe_tpu_torch.ops.stream import build_stream

    kernels.build()
    tok = RegexTokenizer(device="cuda")
    tok.load(os.path.join(ROOT, chip_smoke.CELL_MODEL))
    basic = BasicTokenizer(device="cuda")
    basic.load(os.path.join(ROOT, "bpebench", "data",
                            "minbpe-basic-v512.model"))
    cpu_table = CuckooPairTable(*tok._merge_arrays(), "cpu")
    data, lengths, starts = chip_smoke.cell_documents(
        np, chip_smoke.CELL_SEED)
    byte_ids = engine.device_table(tok).byte_ids

    def stream(raw: bytes):
        d = torch.frombuffer(bytearray(raw), dtype=torch.uint8).cuda()
        _, seg, ids = pdp.presplit_seg_ids(d, len(raw), 4, byte_ids)
        return ids, seg

    def k17(t, ids, seg):
        return kernels.segment_encode(ids, seg, engine.device_table(t).cuckoo)

    def k10(t, ids, seg):
        table = engine.device_table(t)
        return kernels.encode_sweep(ids, seg, table.pairs, table.new_ids)

    def same(t, ids, seg):
        a, b = k17(t, ids, seg), k10(t, ids, seg)
        k = int(b[2])
        return int(a[2]) == k and torch.equal(a[0][:k], b[0][:k]) and \
            torch.equal(a[1][:k], b[1][:k]), k

    def shape(name, raw: bytes, reps: int):
        ids, seg = stream(raw)
        ok, k = same(tok, ids, seg)
        if not ok:
            raise AssertionError(f"{name}: K17 differs from K10")
        n = ids.numel()
        ci, cs = ids.cpu(), seg.cpu()
        t0 = time.perf_counter()
        kernels.segment_encode_plain(ci, cs, cpu_table)
        plain = (time.perf_counter() - t0) * 1e3
        rec = dict(case=name, bytes=len(raw), tokens_out=k,
                   k17_ms=chip_smoke.device_ms(
                       torch, lambda: k17(tok, ids, seg), reps),
                   k10_ms=chip_smoke.device_ms(
                       torch, lambda: k10(tok, ids, seg), reps),
                   bound_ms=(8 * n + 8 * k) / chip_smoke.HBM_BYTES_PER_S
                   * 1e3,
                   plain_ms=plain)
        print(json.dumps(rec))
        return rec

    cases = [shape(name, raw, args.reps)
             for name, raw in chip_smoke.cell_shapes(np, data, lengths,
                                                     starts)]
    cases.append(shape("smoke_corpus", data, 5))

    per_doc = {"k17": [], "k10": []}
    total = 0
    for i in range(min(args.docs, len(lengths))):
        raw = data[starts[i]:starts[i] + lengths[i]]
        ids, seg = stream(raw)
        ok, _ = same(tok, ids, seg)
        if not ok:
            raise AssertionError(f"document {i}: K17 differs from K10")
        per_doc["k17"].append(chip_smoke.device_ms(
            torch, lambda: k17(tok, ids, seg), 10))
        per_doc["k10"].append(chip_smoke.device_ms(
            torch, lambda: k10(tok, ids, seg), 10))
        total += len(raw)
    docs = {name: dict(sum_ms=sum(v), median_ms=statistics.median(v),
                       ms_per_MB=sum(v) / (total / 1e6))
            for name, v in per_doc.items()}

    def host_split(name, t, parts):
        """A stream the host cuts, of parts (bytes, split): a part split by
        t's pattern, or one segment; both kernels, and the route
        short_segments picks."""
        arrays = [t._split_arrays(p.decode("utf-8", "replace")) if split
                  else (np.frombuffer(p, np.uint8),
                        np.array([len(p)], np.int64)) for p, split in parts]
        offs = np.cumsum([0] + [len(a) for a, _ in arrays])
        flat = np.concatenate([a for a, _ in arrays])
        ends = np.concatenate([e + offs[k] for k, (_, e) in
                               enumerate(arrays)])
        seg_lens = np.diff(ends, prepend=0)
        ids, seg = build_stream(flat, ends, "cuda")
        ok, k = same(t, ids, seg)
        if not ok:
            raise AssertionError(f"{name}: K17 differs from K10")
        reps = 3 if flat.size > (1 << 18) else 10
        rec = dict(case=name, bytes=int(flat.size),
                   segments=int(seg_lens.size),
                   longest=int(seg_lens.max()), tokens_out=k,
                   route=("segment_encode" if short_segments(seg_lens)
                          else "encode_sweep"),
                   k17_ms=chip_smoke.device_ms(
                       torch, lambda: k17(t, ids, seg), reps),
                   k10_ms=chip_smoke.device_ms(
                       torch, lambda: k10(t, ids, seg), reps))
        print(json.dumps(rec))
        return rec

    def text_bytes(size: int) -> bytes:
        return (data * (size // len(data) + 1))[:size]

    long_cases = [host_split(f"basic_batch_{d}x{size >> 10}k", basic,
                             [(text_bytes(size + 997 * j)[997 * j:], False)
                              for j in range(d)])
                  for size in (1 << 16, 1 << 20) for d in (2, 4)]
    long_cases.append(host_split(
        "regex_chunk_70000", tok,
        [(data[:50_000] + b"-" * 70_000 + data[:50_000], True)]))
    for L in LONG:
        long_cases.append(host_split(
            f"smoke20k_plus_segment_{L}", tok,
            [(data[:20_000], True), (text_bytes(20_000 + L)[20_000:], False)]))
    print(json.dumps(dict(cases=cases, documents=len(per_doc["k17"]),
                          document_bytes=total, docs=docs,
                          long=long_cases,
                          retaken=len(chip_smoke.RETAKEN_READINGS))))
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
