"""Tokenizer contract, persistence, and rendering helpers.

Host-side API layer of the TPU-native framework. Public surface and on-disk
format are behavior-compatible with the reference (karpathy/minbpe):

- state = merges / pattern / special_tokens / vocab (minbpe/base.py:69-74)
- deterministic vocab derivation (minbpe/base.py:88-95)
- ``minbpe v1`` .model / .vocab save + load grammar (minbpe/base.py:97-165)
- control-character-escaping token rendering (minbpe/base.py:44-61)

The port's copy of minbpe_tpu/base.py. The compute paths (train/encode)
live in subclasses and run on the tokenizer's device through
minbpe_tpu_torch.engine; this module stays on the host, since persistence
and pretty-printing are not kernel work. The one addition is the device:
CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import unicodedata

import numpy as np
import torch


def escape_control_characters(s: str) -> str:
    """Escape Unicode category-C characters as \\uXXXX (minbpe/base.py:44-55)."""
    out = []
    for ch in s:
        if unicodedata.category(ch).startswith("C"):
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(ch)
    return "".join(out)


def resolve_device(device=None) -> torch.device:
    """The device a tokenizer runs on: "cuda" unless the caller names one.

    Without CUDA, only an explicit device="cpu" runs, on the kernels' plain
    PyTorch versions; there is no quiet CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path")
    return dev


def render_token(t: bytes) -> str:
    """Human-readable lossy rendering of a token (minbpe/base.py:57-61)."""
    return escape_control_characters(t.decode("utf-8", errors="replace"))


def id_array(ids) -> np.ndarray:
    """Any iterable of ints (list, tuple, range, numpy array, generator) as
    one flat int64 array, materialised once, as the reference's
    ``b"".join(vocab[idx] for idx in ids)`` takes any of them."""
    if not isinstance(ids, (np.ndarray, list, tuple, range)):
        ids = list(ids)
    return np.asarray(ids, dtype=np.int64).ravel()


class DecodeTable:
    """Vectorized id -> bytes concatenation for decode.

    The reference decodes with a per-id dict lookup + join
    (minbpe/basic.py:51-55); at MB scale that Python loop is the decode
    floor. This flattens the vocab once into a single uint8 table plus
    starts/lengths arrays, so decoding any id sequence is one numpy gather:
    out[k] = table[starts[ids] broadcast + offsets], built via the standard
    repeat/cumsum expansion. Unknown ids are reported (not raised) so callers
    keep their exact reference exception semantics (KeyError vs ValueError).
    """

    def __init__(self, mapping: dict[int, bytes]):
        n = (max(mapping) + 1) if mapping else 0
        self.lens = np.full(n, -1, dtype=np.int64)
        self.starts = np.zeros(n, dtype=np.int64)
        parts = []
        pos = 0
        for k in sorted(mapping):
            b = mapping[k]
            self.starts[k] = pos
            self.lens[k] = len(b)
            pos += len(b)
            parts.append(b)
        self.table = np.frombuffer(b"".join(parts), dtype=np.uint8)

    def lookup(self, ids) -> tuple[bytes, int]:
        """(concatenated bytes, index of first unknown id or -1); ids: any
        iterable of ints, the index one into ``id_array(ids)``."""
        a = id_array(ids)
        if a.size == 0:
            return b"", -1
        ok = (a >= 0) & (a < self.lens.size)
        l = np.where(ok, self.lens[np.where(ok, a, 0)], -1)
        bad = np.nonzero(l < 0)[0]
        if bad.size:
            return b"", int(bad[0])
        s = self.starts[a]
        cum = np.cumsum(l)
        out_idx = (np.arange(int(cum[-1]), dtype=np.int64)
                   - np.repeat(cum - l, l) + np.repeat(s, l))
        return self.table[out_idx].tobytes(), -1


class Tokenizer:
    """Base tokenizer: abstract train/encode/decode + save/load.

    Mirrors the reference contract (minbpe/base.py:66-95).
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.merges: dict[tuple[int, int], int] = {}
        self.pattern: str = ""
        self.special_tokens: dict[str, int] = {}
        self.vocab: dict[int, bytes] = self._build_vocab()
        self._invalidate_device_state()

    # -- abstract compute surface ------------------------------------------
    def train(self, text, vocab_size, verbose=False):
        raise NotImplementedError

    def encode(self, text):
        raise NotImplementedError

    def decode(self, ids):
        raise NotImplementedError

    # -- derived state ------------------------------------------------------
    def _build_vocab(self) -> dict[int, bytes]:
        """bytes 0..255, then merges in rank order, then specials
        (minbpe/base.py:88-95)."""
        vocab = {idx: bytes([idx]) for idx in range(256)}
        for (p0, p1), idx in self.merges.items():
            vocab[idx] = vocab[p0] + vocab[p1]
        for special, idx in self.special_tokens.items():
            vocab[idx] = special.encode("utf-8")
        return vocab

    def _transform_bytes_array(self, arr):
        """Byte-level preprocessing before BPE, on the uint8 array of a
        text's bytes (minbpe_tpu/regex.py:69-72): the identity here;
        GPT4Tokenizer's byte shuffle."""
        return arr

    def _invalidate_device_state(self):
        """Drop the cached device merge table (its byte ids with it) and
        the decode table (call after merges, specials or the byte
        transform change)."""
        self._dev = None
        self._dtab = None

    def _decode_table(self, mapping: dict[int, bytes]) -> DecodeTable:
        """Lazily built, invalidated by _invalidate_device_state."""
        if self._dtab is None:
            self._dtab = DecodeTable(mapping)
        return self._dtab

    def _merge_arrays(self):
        """merges dict -> (pairs[M,2], new_ids[M]) numpy arrays in rank order.

        Rank order is dict insertion order, which save/load and training both
        keep as ascending new-token-id order (minbpe/base.py:115,159-162).
        """
        items = sorted(self.merges.items(), key=lambda kv: kv[1])
        if items:
            pairs = np.array([[p[0], p[1]] for p, _ in items], dtype=np.int32)
            new_ids = np.array([idx for _, idx in items], dtype=np.int32)
        else:
            pairs = np.zeros((0, 2), dtype=np.int32)
            new_ids = np.zeros((0,), dtype=np.int32)
        return pairs, new_ids

    # -- persistence (minbpe v1 interchange format) -------------------------
    def save(self, file_prefix: str):
        """Write <prefix>.model (load-critical) and <prefix>.vocab (human-only).

        Format per minbpe/base.py:97-138: version line, pattern line, special
        count, ``token idx`` lines, then one ``idx1 idx2`` line per merge in
        rank order (ranks are positional).
        """
        with open(file_prefix + ".model", "w") as f:
            f.write("minbpe v1\n")
            f.write(f"{self.pattern}\n")
            f.write(f"{len(self.special_tokens)}\n")
            for special, idx in self.special_tokens.items():
                f.write(f"{special} {idx}\n")
            for (idx1, idx2), _ in sorted(self.merges.items(), key=lambda kv: kv[1]):
                f.write(f"{idx1} {idx2}\n")

        inverted = {idx: pair for pair, idx in self.merges.items()}
        with open(file_prefix + ".vocab", "w", encoding="utf-8") as f:
            for idx, token in self.vocab.items():
                s = render_token(token)
                if idx in inverted:
                    i0, i1 = inverted[idx]
                    f.write(
                        f"[{render_token(self.vocab[i0])}]"
                        f"[{render_token(self.vocab[i1])}] -> [{s}] {idx}\n"
                    )
                else:
                    f.write(f"[{s}] {idx}\n")

    def load(self, model_file: str):
        """Inverse of save() for the .model file (minbpe/base.py:140-165)."""
        assert model_file.endswith(".model")
        merges: dict[tuple[int, int], int] = {}
        special_tokens: dict[str, int] = {}
        idx = 256
        with open(model_file, "r", encoding="utf-8") as f:
            version = f.readline().strip()
            assert version == "minbpe v1"
            self.pattern = f.readline().strip()
            num_special = int(f.readline().strip())
            for _ in range(num_special):
                special, special_idx = f.readline().strip().split()
                special_tokens[special] = int(special_idx)
            for line in f:
                idx1, idx2 = map(int, line.split())
                merges[(idx1, idx2)] = idx
                idx += 1
        self.merges = merges
        self.special_tokens = special_tokens
        self.vocab = self._build_vocab()
        self._invalidate_device_state()
