"""XMem training entry point (reference ``XMem/train.py``).

Counterpart of ``d3fields_tpu/apps/train_xmem.py``, with the same flags:

  python -m d3fields_tpu_torch.apps.train_xmem --synthetic --steps 5 \\
      --batch 2 --out out/xmem_train
  python -m d3fields_tpu_torch.apps.train_xmem --data_root <videos> --steps 1000
  # the reference's staged curriculum (s0 -> s3):
  python -m d3fields_tpu_torch.apps.train_xmem --stage 0 --static_root <imgs>
  python -m d3fields_tpu_torch.apps.train_xmem --stage 3 --davis_root <DAVIS> \\
      --yv_root <YouTubeVOS> --load_network out/xmem_train/ckpt_final.pt

  # data parallel over 4 GPUs: the app starts one process per GPU itself,
  # or runs under a launcher that started them
  python -m d3fields_tpu_torch.apps.train_xmem --data_root <videos> --dp 4
  torchrun --nproc_per_node 4 -m d3fields_tpu_torch.apps.train_xmem \\
      --data_root <videos> --dp 4

Stage presets (reference ``util/configuration.py:35-79``) fill batch size,
iteration budget, LR schedule, clip length, num_ref_frames and the warm-up
window; the temporal-skip curriculum and the low-augmentation finetune
tail mirror ``train.py:155-236``. Without ``--dp`` one process trains on
one device: CUDA unless ``main`` is given another.

``--dp N`` (N > 1) is the JAX app's data-parallel mesh as N processes of a
``torch.distributed`` group (the reference's DDP, ``XMem/train.py:25``).
``--batch`` is the global batch and must divide by N. Every rank builds
the same loader, draws the global batch and keeps its rows;
``trainer.train_step`` averages the gradients over the group. The group
is the caller's where one is started, else a launcher's (``torchrun``,
srun: ``parallel.initialize_distributed``), else the app spawns N local
ranks, one per visible GPU, over NCCL (gloo when ``main`` is given the
CPU). Each rank runs on the CUDA device made current where its group was
started (``cuda:LOCAL_RANK``, or srun's ``SLURM_LOCALID``) unless
``main`` is given a device. Rank 0's weights are broadcast at the start;
only rank 0 prints, logs, writes checkpoints and dumps images.

Checkpoints are ``torch.save`` files (``ckpt_<it>.pt``, ``ckpt_final.pt``)
that ``--resume``, ``--load_network`` and ``eval_xmem --ckpt`` read;
``--resume`` and ``--load_network`` also take a JAX trainer pickle, and
``--load_network`` the reference's ``XMem.pth``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket
import sys
import time


# Stage hyperparameter presets — the reference's staged Configuration
# defaults (XMem/util/configuration.py:35-79; single_object for s0 from
# train.py:61). "steps" is the iteration budget; "lr_steps" the MultiStep
# LR decay points; "finetune" the low-augmentation tail.
STAGE_PRESETS = {
    0: dict(batch=16, steps=150_000, finetune=0, lr_steps=(), lr=1e-5,
            num_ref_frames=2, num_frames=3, start_warm=20_000,
            end_warm=70_000, max_num_obj=1),
    1: dict(batch=8, steps=250_000, finetune=0, lr_steps=(200_000,), lr=1e-5,
            num_ref_frames=3, num_frames=8, start_warm=20_000,
            end_warm=70_000, max_num_obj=3),
    2: dict(batch=8, steps=150_000, finetune=10_000, lr_steps=(120_000,),
            lr=1e-5, num_ref_frames=3, num_frames=8, start_warm=20_000,
            end_warm=70_000, max_num_obj=3),
    3: dict(batch=8, steps=100_000, finetune=10_000, lr_steps=(80_000,),
            lr=1e-5, num_ref_frames=3, num_frames=8, start_warm=20_000,
            end_warm=70_000, max_num_obj=3),
}

# free-form (no --stage) defaults: tiny smoke-run scale
_FREEFORM = dict(batch=2, steps=100, finetune=0, lr_steps=(), lr=1e-5,
                 num_ref_frames=0, num_frames=3, start_warm=20_000,
                 end_warm=70_000, max_num_obj=2)

MAX_PENDING_LOSSES = 4


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--stage", type=int, default=None, choices=(0, 1, 2, 3),
                   help="reference curriculum stage: 0 static pretraining, "
                        "1 BL30K, 2/3 DAVIS+YouTubeVOS; presets fill any "
                        "hyperparameter not given explicitly")
    p.add_argument("--data_root", default=None,
                   help="single video root (generic <video>/{frames,masks}, "
                        "DAVIS or YouTubeVOS checkout layout)")
    p.add_argument("--davis_root", default=None,
                   help="DAVIS checkout for the stage-2/3 mixture "
                        "(sampled with 5x weight, reference train.py:132)")
    p.add_argument("--yv_root", default=None,
                   help="YouTubeVOS checkout for the stage-2/3 mixture "
                        "(max_skip // 5: annotations every five frames)")
    p.add_argument("--static_root", default=None,
                   help="static X.jpg + X.png pairs -> pseudo-video clips "
                        "(the reference's s0 pretraining stage)")
    p.add_argument("--subset", default="train",
                   help="ImageSets split for --davis_root/--yv_root "
                        "(reference load_sub_davis/load_sub_yv); checkouts "
                        "without a split file use all videos")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--finetune", type=int, default=None,
                   help="extra low-augmentation steps after --steps "
                        "(reference train.py:232-236)")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--num_frames", type=int, default=None)
    p.add_argument("--num_ref_frames", type=int, default=None,
                   help="memory frames per training query (0 = all)")
    p.add_argument("--max_jump", type=int, default=5)
    p.add_argument("--max_num_obj", type=int, default=None)
    p.add_argument("--size", type=int, nargs=2, default=(96, 128))
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr_steps", type=int, nargs="*", default=None,
                   help="MultiStep LR decay iterations")
    p.add_argument("--start_warm", type=int, default=None)
    p.add_argument("--end_warm", type=int, default=None)
    p.add_argument("--dp", type=int, default=0,
                   help="0 = single device; N > 1: N data-parallel ranks, one "
                        "per GPU (a launcher's, or spawned here); --batch is "
                        "the global batch")
    p.add_argument("--key_dim", type=int, default=64)
    p.add_argument("--value_dim", type=int, default=512)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--resume", default=None,
                   help="a train_xmem checkpoint or a JAX trainer pickle: "
                        "model, optimizer state and iteration")
    p.add_argument("--load_network", default=None,
                   help="init params from this checkpoint but start the "
                        "stage fresh (optimizer + iteration reset) — the "
                        "reference's previous-stage handoff, train.py:100-104")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--dump_images_every", type=int, default=0,
                   help="save frame|gt|pred training grids every N steps "
                        "(the reference image_saver; 0 = off)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--out", default="out/xmem_train")
    return p


def resolve_stage_args(args):
    """Fill every None hyperparameter from the stage preset (or the
    free-form defaults when --stage is absent); explicit flags win."""
    preset = STAGE_PRESETS[args.stage] if args.stage is not None else _FREEFORM
    for k, v in preset.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    args.lr_steps = tuple(args.lr_steps)
    return args


def make_loader(args):
    """The clip loader of the data flags, and whether the temporal-skip
    curriculum applies (video data only)."""
    from d3fields_tpu_torch.models.xmem.data import (
        DirectoryVideoSource, MixedClipLoader, StaticImageSource,
        SyntheticVideoSource, VideoClipLoader)

    def clips(source, seed=0):
        return VideoClipLoader(
            source, num_frames=args.num_frames, max_jump=args.max_jump,
            max_num_obj=args.max_num_obj, out_hw=tuple(args.size), seed=seed,
        )

    if args.synthetic:
        return clips(SyntheticVideoSource(hw=tuple(args.size))), False
    if args.static_root:
        return clips(StaticImageSource(root=args.static_root)), False
    if args.davis_root or args.yv_root:
        # the reference's ConcatDataset([davis]*5 + [yv]) mixture
        # (train.py:125-138); either root alone degrades to that dataset
        loaders, weights, divisors = [], [], []
        if args.davis_root:
            src = DirectoryVideoSource(args.davis_root, subset=args.subset)
            print(f"[train_xmem] DAVIS: {len(src.videos)} videos")
            loaders.append(clips(src))
            weights.append(5.0 * len(src.videos))
            divisors.append(1)
        if args.yv_root:
            src = DirectoryVideoSource(args.yv_root, subset=args.subset)
            print(f"[train_xmem] YouTubeVOS: {len(src.videos)} videos")
            loaders.append(clips(src, seed=1))
            weights.append(float(len(src.videos)))
            divisors.append(5)
        return MixedClipLoader(loaders, weights, jump_divisors=divisors), True
    if args.data_root:
        return clips(DirectoryVideoSource(args.data_root)), True
    raise SystemExit("need --data_root, --davis_root/--yv_root, "
                     "--static_root or --synthetic")


def initial_state(args, cfg, spec, device):
    """The train state of ``--resume`` (a checkpoint of this app or a JAX
    trainer pickle), of ``--load_network`` (weights only, fresh optimizer
    and iteration: the reference's previous-stage handoff,
    ``train.py:100-104``), or of seeded random weights."""
    from d3fields_tpu_torch.apps._backends import load_xmem
    from d3fields_tpu_torch.models.xmem import network as N
    from d3fields_tpu_torch.models.xmem import trainer as TR
    from d3fields_tpu_torch.utils.convert import read_trainer_pickle

    if args.resume:
        blob = read_trainer_pickle(args.resume)
        if blob is not None:
            state = TR.load_jax_train_state(blob, cfg, spec, device)
        else:
            state = TR.load_checkpoint(args.resume, cfg, spec, device)
        print(f"[train_xmem] resumed from {args.resume} at it={state.it}")
        return state
    if args.load_network:
        model = load_xmem(args.load_network, cfg, device)
        print(f"[train_xmem] network initialized from {args.load_network}")
    else:
        model = N.init_params(cfg, device=device)
    return TR.init_train_state(model, spec)


def main(argv=None, *, device=None):
    """The CLI. ``device`` defaults to CUDA and raises when no GPU is visible."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = resolve_stage_args(build_parser().parse_args(argv))
    if args.dp <= 1:
        return train(args, device)
    import torch.distributed as dist

    from d3fields_tpu_torch.parallel import initialize_distributed

    if args.batch % args.dp:
        raise ValueError(f"batch count {args.batch} not divisible by mesh axis 'dp' of "
                         f"size {args.dp}")
    started = not dist.is_initialized() and initialize_distributed(
        device="cuda" if device is None else device)
    if not dist.is_initialized():
        return _spawn_ranks(argv, args.dp, device)
    try:
        if dist.get_world_size() != args.dp:
            raise ValueError(f"--dp {args.dp} in a process group of "
                             f"{dist.get_world_size()} ranks")
        with contextlib.ExitStack() as stack:
            if dist.get_rank():  # rank 0 alone prints
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            code = train(args, _rank_device(device))
        dist.barrier()
        return code
    finally:
        if started:
            dist.destroy_process_group()


def _rank_device(device):
    """This rank's device: the caller's, or the CUDA device made current
    where the group was started (``initialize_distributed`` picks the
    launcher's local rank) when the caller named no CUDA index."""
    import torch

    from d3fields_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _spawn_ranks(argv, world: int, device) -> int:
    """Run ``main(argv, device=device)`` in ``world`` spawned local ranks of
    a new group on a free ``localhost`` port: NCCL with one rank per
    visible GPU (``RuntimeError`` when fewer are visible), or gloo on the
    CPU. Returns 1 as soon as a rank fails (the others are stopped), else
    0."""
    import multiprocessing
    from multiprocessing.connection import wait

    import torch

    from d3fields_tpu_torch.utils.device import resolve_device

    if resolve_device(device).type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"--dp {world}: {world} CUDA device(s) asked for, "
                           f"{torch.cuda.device_count()} visible")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        addr = f"localhost:{sk.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, world, addr, argv, device))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        running = procs
        while running and not any(p.exitcode for p in procs):
            wait([p.sentinel for p in running])
            running = [p for p in running if p.exitcode is None]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return 0 if all(p.exitcode == 0 for p in procs) else 1


def _rank_main(rank: int, world: int, addr: str, argv, device) -> None:
    """One spawned rank: start its group, train, leave the group."""
    import torch.distributed as dist

    from d3fields_tpu_torch.parallel import initialize_distributed

    os.environ["LOCAL_RANK"] = str(rank)
    initialize_distributed(addr, world, rank, device="cuda" if device is None else device)
    try:
        code = main(argv, device=device)
    finally:
        dist.destroy_process_group()
    if code:
        raise SystemExit(code)


def train(args, device) -> int:
    """The training loop on ``device``: in one process, or as this rank of
    the process group when ``args.dp`` > 1 (its rows of each global batch;
    rank 0 alone logs and writes)."""
    from d3fields_tpu_torch.config import XMemConfig
    from d3fields_tpu_torch.models.xmem import trainer as TR
    from d3fields_tpu_torch.models.xmem.data import max_skip_schedule, skip_at
    from d3fields_tpu_torch.utils.device import resolve_device
    from d3fields_tpu_torch.utils.metrics import Integrator, JsonlLogger

    device = resolve_device(device)
    os.makedirs(args.out, exist_ok=True)
    cfg = XMemConfig(key_dim=args.key_dim, value_dim=args.value_dim,
                     hidden_dim=args.hidden_dim)
    loader, scheduled = make_loader(args)
    schedule = (max_skip_schedule(args.stage, args.steps)
                if scheduled and args.stage not in (None, 0) else [])
    spec = TR.make_optimizer(lr=args.lr, steps=args.lr_steps)
    state = initial_state(args, cfg, spec, device)
    rank, shard = 0, args.batch
    if args.dp > 1:
        import torch.distributed as dist

        from d3fields_tpu_torch.parallel import broadcast_tensors

        rank, shard = dist.get_rank(), args.batch // args.dp
        broadcast_tensors([t for _, t in TR.train_leaves(state.model)])
    rows = slice(rank * shard, (rank + 1) * shard)
    lead = rank == 0

    logger = JsonlLogger(os.path.join(args.out, "train.jsonl"), "xmem") if lead else None
    integ = Integrator(logger)
    t0 = time.perf_counter()
    total_iters = args.steps + args.finetune
    cur_skip = args.max_jump
    finetuning = False
    step = 0
    # The loss stays on the device until a log boundary, so that the host
    # loads batch t+1 while the card runs step t; at most
    # MAX_PENDING_LOSSES are left unread (the oldest is read first), which
    # bounds how far the host runs ahead.
    pending_losses = []
    while state.it < total_iters:
        it = state.it
        if schedule:
            want = skip_at(schedule, it, initial=args.max_jump)
            if want != cur_skip:
                cur_skip = want
                loader.set_max_jump(cur_skip)
                print(f"[train_xmem] it={it} max_skip -> {cur_skip}")
        if args.finetune > 0 and not finetuning and it >= args.steps:
            # low-augmentation tail to train the sensory memory
            # (reference train.py:232-236)
            finetuning = True
            loader.set_finetune(True)
            print(f"[train_xmem] it={it} entering finetune phase")
        # every rank draws the global batch from the same loader and keeps
        # its rows, as a JAX process feeds shard_leading the global batch
        batch = loader.batch(args.batch)
        state, out = TR.train_step(
            state, TR.to_device_batch({k: v[rows] for k, v in batch.items()}, device),
            num_ref_frames=args.num_ref_frames, start_warm=args.start_warm,
            end_warm=args.end_warm)
        step += 1
        if not lead:
            continue
        pending_losses.append(out["loss"])
        if len(pending_losses) > MAX_PENDING_LOSSES:
            integ.add_dict({"loss": float(pending_losses.pop(0))})
        if step % args.log_every == 0:
            for loss in pending_losses:
                integ.add_dict({"loss": float(loss)})
            pending_losses.clear()
            stats = integ.finalize("train", state.it)
            integ.reset()
            dt = (time.perf_counter() - t0) / args.log_every
            t0 = time.perf_counter()
            print(f"[train_xmem] it={state.it} loss={stats['loss']:.4f} "
                  f"{dt:.2f}s/step")
        if args.dump_images_every and step % args.dump_images_every == 0:
            _dump_train_images(args.out, state, batch, device)
        if step % args.save_every == 0:
            TR.save_checkpoint(os.path.join(args.out, f"ckpt_{state.it}.pt"), state)
    if lead:
        TR.save_checkpoint(os.path.join(args.out, "ckpt_final.pt"), state)
        logger.close()
        print(f"[train_xmem] done; final checkpoint in {args.out}")
    return 0


def _dump_train_images(out_dir, state, batch, device):
    """frame | GT | prediction grid for batch sample 0 (the reference's
    periodic image dumps, ``XMem/util/image_saver.py``), as a PNG."""
    import numpy as np
    import torch

    from d3fields_tpu_torch.models.common import IMAGENET_MEAN, IMAGENET_STD
    from d3fields_tpu_torch.models.xmem import trainer as TR
    from d3fields_tpu_torch.utils.png import save_png
    from d3fields_tpu_torch.utils.visualization import davis_palette

    one = TR.to_device_batch({k: np.asarray(v)[:1] for k, v in batch.items()}, device)
    with torch.no_grad():
        last_prob = TR.sequence_loss(state.model, one, state.it, return_probs=True)[1]["last_prob"]
    pal = davis_palette()
    frame = np.asarray(batch["frames"][0, -1])
    frame = np.clip((frame * IMAGENET_STD + IMAGENET_MEAN) * 255, 0, 255)
    gt = pal[np.asarray(batch["cls_gt"][0, -1], np.int64)]
    pred = pal[last_prob[0].argmax(0).cpu().numpy().astype(np.int64)]
    grid = np.concatenate([frame, gt, pred], axis=1).astype(np.uint8)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    save_png(os.path.join(out_dir, "images", f"{state.it:07d}.png"), grid[..., ::-1])


if __name__ == "__main__":
    raise SystemExit(main())
