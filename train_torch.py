"""Train Basic and Regex tokenizers on a corpus and save the models: the
command line of minbpe_tpu_torch, with train.py's flags and files.

    python train_torch.py [--corpus PATH] [--vocab-size 512]
                          [--outdir models_out] [--tokenizers basic,regex]
                          [--pattern gpt4|gpt2] [--select-mode auto|...]
                          [--checkpoint-every N] [--resume]
                          [--profile-dir DIR] [--distributed]
                          [--selection dense|sparse|owner] [--quiet]
                          [--device cuda|cpu]

Each tokenizer NAME writes <outdir>/NAME.model and NAME.vocab, and with
--checkpoint-every its checkpoint <outdir>/NAME.ckpt.npz (the format both
packages read). --distributed trains over torch.distributed: the group
torchrun sets up (``torchrun --nproc-per-node G train_torch.py
--distributed ...``), or else a group of one rank (NCCL on cuda, gloo on
cpu). ``main(argv)`` runs it in-process.
"""

from __future__ import annotations

import argparse
import os
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train minbpe_tpu_torch tokenizers and save them.")
    ap.add_argument("--corpus", default=None,
                    help="UTF-8 text file (default: the in-repo smoke corpus "
                    "of minbpe_tpu_torch/utils/golden.py, built from the "
                    "repository's own text, since the reference's "
                    "taylorswift.txt is not in the repository)")
    ap.add_argument("--vocab-size", type=int, default=512)
    ap.add_argument("--outdir", default="models_out")
    ap.add_argument("--tokenizers", default="basic,regex")
    ap.add_argument("--pattern", choices=["gpt4", "gpt2"], default="gpt4")
    ap.add_argument("--select-mode", default="auto")
    ap.add_argument("--checkpoint-every", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint in --outdir")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace here")
    ap.add_argument("--distributed", action="store_true",
                    help="train over torch.distributed "
                    "(minbpe_tpu_torch/parallel/train.py; --checkpoint-every "
                    "and --resume through its stepped trainer)")
    ap.add_argument("--selection", default="dense",
                    choices=["dense", "sparse", "owner"],
                    help="distributed selection mode")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the CUDA kernels; cpu their plain "
                    "PyTorch versions")
    return ap


def _process_group(device: str) -> bool:
    """Make sure a default process group exists: torchrun's (from its
    environment), or else one of a single rank on localhost. Returns
    whether this call made it (and so must destroy it)."""
    import torch.distributed as dist

    from minbpe_tpu_torch.parallel import multihost

    if dist.is_initialized():
        return False
    backend = "nccl" if device == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        multihost.initialize(backend)
    else:
        multihost.initialize(
            backend, init_method=f"tcp://localhost:{multihost.free_port()}",
            rank=0, world_size=1)
    return True


def main(argv=None) -> None:
    args = _parser().parse_args(argv)

    import torch.distributed as dist

    from minbpe_tpu_torch import (BasicTokenizer, GPT2_SPLIT_PATTERN,
                                  RegexTokenizer)
    from minbpe_tpu_torch.ops.train_select import DENSE_SELECT_MAX

    if args.corpus is None:
        from minbpe_tpu_torch.utils.golden import smoke_corpus

        text = smoke_corpus(ROOT)
    else:
        with open(args.corpus, encoding="utf-8") as f:
            text = f.read()
    os.makedirs(args.outdir, exist_ok=True)
    pattern = GPT2_SPLIT_PATTERN if args.pattern == "gpt2" else None
    dist_device = None if args.device == "cuda" else "cpu"
    made_group = _process_group(args.device) if args.distributed else False
    lead = not args.distributed or dist.get_rank() == 0  # prints and saves

    try:
        t0 = time.time()
        for name in args.tokenizers.split(","):
            name = name.strip()
            if name == "basic":
                tok = BasicTokenizer(device=args.device)
            elif name == "regex":
                tok = RegexTokenizer(pattern=pattern, device=args.device)
            else:
                raise SystemExit(f"unknown tokenizer {name!r}")
            opts = {"select_mode": args.select_mode}
            ck = os.path.join(args.outdir, f"{name}.ckpt.npz")
            if args.distributed:
                from minbpe_tpu_torch.parallel.train import (
                    train_bytes_distributed, train_offsets_distributed)

                t1 = time.time()
                verbose = not args.quiet
                if name == "basic":
                    tok.merges, tok.vocab = train_bytes_distributed(
                        text.encode("utf-8"), args.vocab_size - 256,
                        verbose=verbose, device=dist_device)
                else:
                    data, ends = tok._split_arrays(text)
                    tok.merges, tok.vocab = train_offsets_distributed(
                        data, ends, args.vocab_size - 256, verbose=verbose,
                        selection=args.selection, device=dist_device,
                        checkpoint_path=ck if args.checkpoint_every
                        else None,
                        checkpoint_every=args.checkpoint_every,
                        resume_from=ck if args.resume and os.path.exists(ck)
                        else None)
                tok._invalidate_device_state()
                if lead:
                    print(f"{name}: trained vocab {args.vocab_size} "
                          f"distributed in {time.time()-t1:.2f}s")
                    tok.save(os.path.join(args.outdir, name))
                continue
            # checkpoints need a host-stepped loop; dense counting caps at
            # DENSE_SELECT_MAX vocab, above that the sort-round loop
            ck_mode = "stepped" if args.vocab_size <= DENSE_SELECT_MAX \
                else "sortloop"
            if args.checkpoint_every:
                opts.update(checkpoint_path=ck,
                            checkpoint_every=args.checkpoint_every,
                            select_mode=ck_mode)
            if args.resume and os.path.exists(ck):
                opts.update(resume_from=ck, select_mode=ck_mode)
            if args.profile_dir:
                opts.update(profile_dir=args.profile_dir)
            t1 = time.time()
            tok.train(text, args.vocab_size, verbose=not args.quiet, **opts)
            print(f"{name}: trained vocab {args.vocab_size} in "
                  f"{time.time()-t1:.2f}s")
            tok.save(os.path.join(args.outdir, name))
        if lead:
            print(f"total: {time.time()-t0:.2f} seconds")
    finally:
        if made_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
