"""Render/scene configuration (port of `optixpathtracer_tpu/config.py`:
the same fields, defaults and JSON files, so `scenes/config*.json` load
unchanged in both packages; the device is an argument of the entry points,
not a field). A real config system replacing the reference's compile-time
code edits (SURVEY.md section 5.6: scene choice by
uncommenting lines in `main.cpp:95-100`, spp/bounces as consts, hard-coded
output paths)."""
from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class RenderConfig:
    scene: str = "scene3_cornell"   # preset name or path to a .gltf/.glb
    width: int = 1920
    height: int = 1080
    spp: int = 1024                 # reference: maxSamples (|-1024|)
    max_bounces: int = 2            # reference main.cpp:87
    intersect: str = "auto"         # auto|brute|bvh|pallas|walk|packet
    tonemap: str = "srgb"           # srgb | agx | none
    reference_compat: bool = False  # reproduce reference bugs (SURVEY quirks)
    out_exr: Optional[str] = None   # linear EXR (reference's output format)
    out_png: Optional[str] = None
    out_bmp: Optional[str] = None
    checkpoint: Optional[str] = None  # .npz accumulator checkpoint path
    checkpoint_every: int = 64        # samples between checkpoint writes
    sharded: bool = False             # shard rows across the ranks (dist/)
    log_every: int = 10               # progress heartbeat (reference: 10)
    frames_per_launch: int = 16       # spp a render_chunk call

    @classmethod
    def from_json(cls, path: str) -> "RenderConfig":
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**data)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
