"""Long-context LM experiment main (counterpart of
``fedml_tpu/experiments/main_longcontext.py``): a decoder-only
TransformerLM trained with the batch over a ``data`` mesh axis and the
sequence over ``seq`` (``parallel/seq_parallel.py``), K/V shards
rotating between the ranks of a ``seq`` group in ring attention.

``--n_seq 1`` is the local path: each rank runs the whole sequence
through the flash-attention kernels on the card. Launch ``n_data x
n_seq`` ranks for sequence parallelism (``FEDML_TPU_COORDINATOR`` and
its two companions, or ``torchrun``)::

    python -m fedml_tpu_torch.experiments.main_longcontext --n_seq 1 \
        --steps 4
    torchrun --nproc_per_node 2 -m \
        fedml_tpu_torch.experiments.main_longcontext --n_seq 2 \
        --platform cpu --ci 1

``main(argv)`` returns ``(params, losses)``.
"""

from __future__ import annotations

import argparse
import time

from fedml_tpu_torch.experiments import common


def parser():
    p = argparse.ArgumentParser("LongContext-torch")
    common.add_base_args(p)
    a = p.add_argument
    a("--seq_len", type=int, default=512)
    a("--vocab_size", type=int, default=10004)
    a("--n_layers", type=int, default=4)
    a("--n_heads", type=int, default=4)
    a("--d_model", type=int, default=256)
    a("--n_seq", type=int, default=0,
      help="seq-axis mesh size (0 = all ranks on seq, 1 = no sp)")
    a("--n_data", type=int, default=1, help="data-axis mesh size")
    a("--steps", type=int, default=0,
      help="total optimizer steps (0 = --comm_round)")
    a("--ring_block", type=int, default=512,
      help="KV block size inside each ring step")
    a("--moe", type=int, default=0,
      help="1 = Switch-MoE blocks (--moe_experts) instead of dense MLPs")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    common.refuse_unported(args)
    if args.ci:
        args.seq_len = min(args.seq_len, 64)
        args.n_layers = min(args.n_layers, 2)
        args.d_model = min(args.d_model, 64)
        args.vocab_size = min(args.vocab_size, 128)
    device = common.device_for(args)
    logger = common.setup(args, run_name="LongContext")

    import numpy as np
    import torch

    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.parallel.seq_parallel import (
        make_seq_mesh, make_seq_parallel_lm_step, place_lm_batch,
        seq_parallel_model, shift_targets)

    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    n_seq = args.n_seq or max(1, world // args.n_data)
    if args.seq_len % n_seq:
        raise SystemExit(
            f"--seq_len {args.seq_len} must be divisible by the seq mesh "
            f"axis ({n_seq}; set --n_seq / --seq_len accordingly)")
    if args.batch_size % args.n_data:
        raise SystemExit(
            f"--batch_size {args.batch_size} must be divisible by "
            f"--n_data {args.n_data}")
    mesh = make_seq_mesh(args.n_data, n_seq, device=device)
    kw = dict(vocab_size=args.vocab_size, n_layers=args.n_layers,
              n_heads=args.n_heads, d_model=args.d_model,
              max_len=args.seq_len,
              dtype=(torch.bfloat16
                     if args.model_dtype in ("bf16", "bfloat16")
                     else torch.float32))
    model_cls = TransformerLM
    if args.moe:
        # experts replicate over the mesh; each rank routes its own tokens
        from fedml_tpu_torch.models.moe import MoETransformerLM
        model_cls = MoETransformerLM
        kw["n_experts"] = args.moe_experts
    if n_seq > 1:
        model = seq_parallel_model(model_cls, mesh,
                                   block_size=args.ring_block, **kw)
    else:
        model = model_cls(**kw)  # the flash-attention local path

    # a synthetic token stream, the same on every rank
    rng = np.random.default_rng(args.seed)
    B, T = args.batch_size, args.seq_len
    data = rng.integers(0, args.vocab_size, (max(args.n_train or 64, B), T))

    # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, decay 1e-4
    init_fn, step_fn = make_seq_parallel_lm_step(
        model, mesh, lambda ps: torch.optim.AdamW(ps, lr=args.lr,
                                                  weight_decay=1e-4))
    params, opt = init_fn(args.seed)

    steps = args.steps or args.comm_round
    t0, losses = time.time(), []
    with common.audit_scope(args, logger, wired=False):
        for step in range(steps):
            lo = (step * B) % max(len(data) - B + 1, 1)
            idx = data[lo:lo + B]
            params, opt, loss = step_fn(
                params, opt, *place_lm_batch(mesh, idx, shift_targets(idx)))
            losses.append(float(loss))
            logger.log({"step": step, "Train/Loss": losses[-1],
                        "tokens_per_s": B * T * (step + 1)
                        / (time.time() - t0),
                        "mesh": f"{args.n_data}x{n_seq}"})
    logger.close()
    return params, losses


if __name__ == "__main__":
    main()
