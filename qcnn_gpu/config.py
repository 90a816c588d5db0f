"""One config system — replacing the reference's three tiers.

The reference spreads configuration over compile-time macros (precision/
layout/launch geometry, mat.cuh:39-101 — changing them required a
rebuild), tf.app.flags (training/main.py:5-21), and per-sequence .ini
files (SURVEY.md §5). Here a single dataclass tree covers engine,
training, and data settings, serializable to/from JSON and consumable by
the CLI (`--config engine.json`) and the library.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional


@dataclasses.dataclass
class EngineConfig:
    impl: str = "auto"  # auto | bf16 | int
    batch_frames: int = 4
    mesh_dp: int = 0  # 0 => single device / auto
    mesh_sp: int = 1
    mesh_sw: int = 1  # frame-column spatial axis (2-D halo sharding)
    out_dir: str = "."
    model_format: str = "vect_c"
    qps: List[int] = dataclasses.field(default_factory=lambda: [22, 27, 32, 37])
    wbits: int = 8  # 8 = reference grid; 4 = INT4 stretch variant


@dataclasses.dataclass
class TrainSettings:
    qp: int = 37
    blu: bool = False
    lr: float = 1e-4
    batch_size: int = 64
    patch: int = 64
    epochs: int = 30
    seed: int = 0


@dataclasses.dataclass
class Config:
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    train: TrainSettings = dataclasses.field(default_factory=TrainSettings)
    data_root: Optional[str] = None

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as fp:
            raw = json.load(fp)
        return cls(
            engine=EngineConfig(**raw.get("engine", {})),
            train=TrainSettings(**raw.get("train", {})),
            data_root=raw.get("data_root"),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            json.dump(dataclasses.asdict(self), fp, indent=2)

    def make_engine(self):
        from qcnn_gpu.engine.runner import Engine

        mesh = None
        if self.engine.mesh_dp > 0:
            from qcnn_gpu.parallel.mesh import make_mesh

            mesh = make_mesh(
                self.engine.mesh_dp, self.engine.mesh_sp, sw=self.engine.mesh_sw
            )
        return Engine(
            impl=self.engine.impl,
            mesh=mesh,
            out_dir=self.engine.out_dir,
            batch_frames=self.engine.batch_frames,
        )
