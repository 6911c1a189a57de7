"""Command-line interface (port of `optixpathtracer_tpu/cli.py`: the same
flags and precedence, config file then flags).

    python -m optixpathtracer_tpu_torch.cli --scene scene3_cornell \\
        --width 512 --height 512 --spp 64 --out-png cornell.png

    python -m optixpathtracer_tpu_torch.cli --config scenes/config5_full.json
    python -m optixpathtracer_tpu_torch.cli --list-scenes

It renders on the GPU; `--device cpu` asks for the CPU (without a GPU and
without that flag it raises). Rows shard over one process a GPU:

    torchrun --nproc-per-node N -m optixpathtracer_tpu_torch.cli \\
        --distributed --sharded --config scenes/config5_full.json
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from .config import RenderConfig


def build_parser():
    p = argparse.ArgumentParser(
        prog="optixpathtracer_tpu_torch",
        description="differentiable path tracer, PyTorch + CUDA")
    p.add_argument("--config", help="JSON config file (flags override it)")
    p.add_argument("--scene", help="preset name or .gltf/.glb path")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int)
    p.add_argument("--max-bounces", type=int, dest="max_bounces")
    p.add_argument("--intersect",
                   choices=["auto", "brute", "bvh", "pallas", "walk",
                            "packet"])
    p.add_argument("--sharded", action="store_true", default=None,
                   help="shard pixel rows across the ranks")
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed group of a torchrun "
                        "launch (RANK, WORLD_SIZE, MASTER_ADDR, LOCAL_RANK)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to render (default: the GPU)")
    p.add_argument("--tonemap", choices=["srgb", "agx", "none"])
    p.add_argument("--reference-compat", action="store_true", default=None,
                   dest="reference_compat",
                   help="reproduce reference quirks/bugs for image parity")
    p.add_argument("--out-exr", dest="out_exr")
    p.add_argument("--out-png", dest="out_png")
    p.add_argument("--out-bmp", dest="out_bmp")
    p.add_argument("--checkpoint")
    p.add_argument("--checkpoint-every", type=int, dest="checkpoint_every")
    p.add_argument("--list-scenes", action="store_true")
    p.add_argument("--preview", type=int, nargs="?", const=8000,
                   metavar="PORT",
                   help="serve an interactive progressive preview (browser "
                        "viewport + WASD/drag fly camera) instead of a "
                        "batch render")
    p.add_argument("--preview-seconds", type=float, default=None,
                   help="auto-stop the preview after N seconds")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render "
                        "to DIR")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.list_scenes:
        from .scene.procedural import PRESETS
        for name in sorted(PRESETS):
            print(name)
        return 0

    from .scene.flatten import _device
    device = _device(args.device)  # raises on "cuda" without a GPU
    cfg = (RenderConfig.from_json(args.config) if args.config
           else RenderConfig())
    for f in dataclasses.fields(RenderConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)

    if args.distributed:
        from .dist import initialize_distributed
        if initialize_distributed(device=device):
            import torch.distributed as dist
            print(f"distributed: rank {dist.get_rank()}/"
                  f"{dist.get_world_size()} ({dist.get_backend()})")

    if args.preview is not None:
        from .preview import run_preview
        from .render import load_scene
        scene, camera = load_scene(cfg, device)
        run_preview(scene, camera, cfg.width, cfg.height, cfg.max_bounces,
                    cfg.intersect, port=args.preview,
                    max_seconds=args.preview_seconds,
                    reference_compat=cfg.reference_compat)
        return 0

    if not (cfg.out_exr or cfg.out_png or cfg.out_bmp):
        print("warning: no --out-exr/--out-png/--out-bmp; rendering only",
              file=sys.stderr)

    from .render import render_config
    if args.profile:
        import os

        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            img = render_config(cfg, device=device)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        img = render_config(cfg, device=device)
    print(f"done: {cfg.width}x{cfg.height}x{cfg.spp}spp "
          f"mean={float(img.mean()):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
