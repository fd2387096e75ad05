"""Write the encode cells' merge tables with the plain reference.

    python3 bpebench/tools/make_tables.py

trains each configuration that names a ``merges`` file on the frozen
corpus it names, to its vocab size, on the CPU (a few seconds each), and
writes the table as a ``minbpe v1`` .model file. The files are data: set-up
loads them and trains nothing.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bpebench import inputs  # noqa: E402
from bpebench.kinds.encode_requests import chunks_of  # noqa: E402
from bpebench.reference import bpe, split  # noqa: E402


def tables(root: str = ROOT) -> dict:
    """{table's path under root: (pattern, merges)} for every configuration
    that names a ``merges`` file."""
    out = {}
    configs = os.path.join(root, "bpebench", "configs")
    for name in sorted(os.listdir(configs)):
        with open(os.path.join(configs, name)) as f:
            config = json.load(f)
        if "merges" not in config:
            continue
        corpus = inputs.corpus_bytes(os.path.join(root, config["corpus"]),
                                     config["corpus_sha256"]).decode("utf-8")
        ids, seg = bpe.stream(chunks_of(config, corpus), "cpu")
        merges = bpe.train(ids, seg, int(config["vocab_size"]) - 256)
        pattern = split.GPT4_SPLIT_PATTERN if config.get("split") else ""
        out[config["merges"]] = (pattern, merges)
    return out


def main():
    for path, (pattern, merges) in tables().items():
        bpe.write_model(os.path.join(ROOT, path), pattern, merges)
        print(path, len(merges), "merges")


if __name__ == "__main__":
    main()
