"""CLI (counterpart of ``gqx/cli.py``): gqx's flags, defaults and choices,
flag for flag (reference main.py:83-122, plus gqx's --backend, --wire,
--compute-dtype, --data-dir, ...), so a gqx command line trains the port.

Example (the canonical HSQ config, reference README.md:3-8):
    python -m gqx_torch.cli --quantizer hsq --network resnet50 --dataset cifar10 \\
        --c-dim 16 --k-bit 8 --n-bit 6 --num-users 8 --batch-size 32 \\
        --logdir logs/hsq

It trains on the CUDA device; ``--platform cpu`` (gqx's flag) runs the
plain PyTorch path on the CPU instead.  Without a CUDA device and without
``--platform cpu`` it raises: nothing falls back to the CPU.  A flag whose
value the port does not implement (``--use-pallas 0``, ``--hsq-passes 6``)
raises as well.

``--backend mesh`` trains on the distributed backend
(``gqx_torch.parallel.collectives``): ``--coordinator-address``,
``--num-processes`` and ``--process-id`` open the process group (NCCL on
the card, gloo with ``--platform cpu``; gqx/cli.py:145), torchrun's
environment opens it without them, and with neither it is a group of one
process.  Two processes on the CPU:
    python -m gqx_torch.cli ... --backend mesh --wire packed --platform cpu \
        --coordinator-address 127.0.0.1:29511 --num-processes 2 --process-id 0
and the same with ``--process-id 1``.
"""

from __future__ import annotations

import argparse

from gqx_torch.config import DATASET_CLASSES, NETWORK_CHOICES, QUANTIZER_CHOICES, GQConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gqx_torch — gradient quantization on CUDA")
    p.add_argument("--network", type=str, default="resnet18", choices=NETWORK_CHOICES)
    p.add_argument("--dataset", type=str, default="cifar10", choices=list(DATASET_CLASSES))
    p.add_argument("--quantizer", type=str, default="hsq", choices=QUANTIZER_CHOICES)
    p.add_argument("--num-classes", type=int, default=None,
                   help="override the dataset's class count "
                        "(reference main.py:85)")
    p.add_argument("--mode", type=str, default="ps", choices=["ps", "ring"])
    p.add_argument("--scale", type=str, default="exp")
    p.add_argument("--c-dim", type=int, default=32)
    p.add_argument("--k-bit", type=int, default=8)
    p.add_argument("--n-bit", type=int, default=8)
    p.add_argument("--cr", type=int, default=256)
    p.add_argument("--random", type=int, default=1)
    p.add_argument("--num-users", type=int, default=8)
    p.add_argument("--logdir", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--test-batch-size", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=None,
                   help="override the schedule's epoch count")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--ef", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log-epoch", type=int, default=1)
    p.add_argument("--save-model", action="store_true", default=False)
    p.add_argument("--two-phase", action="store_true", default=False)
    # gqx extensions
    p.add_argument("--backend", type=str, default="sim", choices=["sim", "mesh"],
                   help="sim: one process simulates every user; mesh: the distributed "
                        "backend (torch.distributed)")
    p.add_argument("--wire", type=str, default="logical", choices=["logical", "packed"],
                   help="mesh PS: all-reduce the decoded means, or all-gather the packed "
                        "payloads")
    p.add_argument("--compute-dtype", type=str, default="float32")
    p.add_argument("--data-dir", type=str, default="./data")
    p.add_argument("--use-pallas", type=int, default=None,
                   help="gqx's TPU kernel switch; the port accepts only 1 or unset")
    p.add_argument("--folded-users", type=int, default=1, choices=[0, 1],
                   help="folded-batch fwd/bwd with per-user weight gradients "
                        "(default on); 0 = a loop over the users")
    p.add_argument("--hsq-passes", type=int, default=1, choices=[1, 2, 6],
                   help="bf16 passes in the HSQ encode (the port implements 1 and 2)")
    p.add_argument("--unit-dtype", type=str, default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="packed compression-unit dtype")
    p.add_argument("--ring-mode", type=str, default="chain", choices=["chain", "segmented"])
    p.add_argument("--platform", type=str, default=None,
                   help="cpu: run on the CPU (plain PyTorch path); unset, cuda "
                        "or gpu: the CUDA device")
    p.add_argument("--host-devices", type=int, default=8,
                   help="gqx's virtual CPU devices for the mesh backend; unused "
                        "by the port")
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume from the latest checkpoint in --logdir")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace of a few steady-state steps here")
    p.add_argument("--profile-steps", type=int, default=5)
    # gqx's multi-process runtime (the distributed backend)
    p.add_argument("--coordinator-address", type=str, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def config_from_args(args) -> GQConfig:
    cfg = GQConfig(
        network=args.network,
        dataset=args.dataset,
        num_classes=args.num_classes,
        quantizer=args.quantizer,
        mode=args.mode,
        scale=args.scale,
        c_dim=args.c_dim,
        k_bit=args.k_bit,
        n_bit=args.n_bit,
        cr=args.cr,
        random=bool(args.random),
        num_users=args.num_users,
        logdir=args.logdir,
        batch_size=args.batch_size,
        test_batch_size=args.test_batch_size,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        ef=args.ef,
        seed=args.seed,
        log_epoch=args.log_epoch,
        save_model=args.save_model,
        two_phase=args.two_phase,
        ring_mode=args.ring_mode,
        unit_dtype=args.unit_dtype,
        backend=args.backend,
        wire=args.wire,
        compute_dtype=args.compute_dtype,
        data_dir=args.data_dir,
        use_pallas=None if args.use_pallas is None else bool(args.use_pallas),
        hsq_passes=args.hsq_passes,
        folded_users=bool(args.folded_users),
        profile_dir=args.profile_dir,
        profile_steps=args.profile_steps,
    )
    if args.epochs is not None:
        cfg.epochs = args.epochs
    return cfg


def device_from_args(args) -> str:
    """gqx's --platform: cpu -> the CPU; unset, cuda or gpu -> the card."""
    if args.platform == "cpu":
        return "cpu"
    if args.platform in (None, "cuda", "gpu"):
        return "cuda"
    raise ValueError(f"gqx_torch: --platform {args.platform!r} is not supported "
                     "(cpu, cuda or gpu)")


def main(argv=None):
    """Parse ``argv``, train; returns run_training's (state, accuracy)."""
    args = build_parser().parse_args(argv)
    device = device_from_args(args)
    cfg = config_from_args(args)
    import torch.distributed as dist

    from gqx_torch.parallel.distributed import maybe_initialize
    from gqx_torch.runner import run_training

    opened = maybe_initialize(args.coordinator_address, args.num_processes, args.process_id,
                              device, world_of_one=cfg.backend == "mesh")
    try:
        return run_training(cfg, epochs_override=args.epochs, resume=args.resume,
                            device=device)
    finally:
        if opened:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
