"""Config / CLI system, a copy of the parts of `scorp_tpu.config` that
rendering and 3DGS/2DGS training need (kept here so the port imports nothing of
the JAX package).

  1. param groups whose attributes become argparse flags, with the
     `shorthand` metadata registering a one-letter alias;
  2. `cfg_args` round-trip: training dumps `Namespace(...)` into the model
     dir, eval tools merge it with the CLI — parsed with an ast-based safe
     parser instead of eval().

Defaults match the original 3DGS ModelParams / PipelineParams /
OptimizationParams exactly.
"""

from __future__ import annotations

import ast
import os
import sys
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass, field, fields


class ParamGroup:
    """Dataclass-backed argparse group. Field metadata 'shorthand' adds a
    one-letter alias."""

    @classmethod
    def add_to_parser(cls, parser: ArgumentParser, name: str):
        group = parser.add_argument_group(name)
        for f in fields(cls):
            flag = "--" + f.name
            names = [flag]
            if f.metadata.get("shorthand"):
                names.append("-" + f.name[0])
            default = f.default
            if f.type in ("bool", bool) or isinstance(default, bool):
                group.add_argument(*names, default=default, action="store_true")
            else:
                t = type(default) if default is not None else str
                group.add_argument(*names, default=default, type=t)

    @classmethod
    def extract(cls, args: Namespace):
        kwargs = {f.name: getattr(args, f.name) for f in fields(cls) if hasattr(args, f.name)}
        return cls(**kwargs)


def sh(default):
    """A field with a one-letter shorthand flag."""
    return field(default=default, metadata={"shorthand": True})


@dataclass
class ModelParams(ParamGroup):
    sh_degree: int = 3
    source_path: str = sh("")
    model_path: str = sh("")
    images: str = sh("images")
    resolution: int = sh(-1)
    white_background: bool = sh(False)
    data_device: str = "cuda"  # accepted for CLI compatibility; the apps' --device decides
    eval: bool = False
    preload: bool = False
    split_yml_name: str = ""

    def finalize(self):
        self.source_path = os.path.abspath(self.source_path)
        return self


@dataclass
class PipelineParams(ParamGroup):
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class OptimizationParams(ParamGroup):
    random_background: bool = True
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_normal: float = 0.05
    lambda_depth_sensor: float = 1.5
    lambda_isotropic: float = 0.0005
    opacity_cull: float = 0.6
    max_screen_size: float = 0.5
    depth_from_iter: int = 7000
    dn_l1_weight_init: float = 0.25
    dn_l1_weight_final: float = 0.075
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 25_000
    densify_grad_threshold: float = 0.0002


@dataclass
class Optimization2DParams(OptimizationParams):
    """2DGS deltas (gs2dgs/arguments/__init__.py:95-109)."""

    lambda_dist: float = 0.0
    depth_ratio: float = 1.0
    opacity_cull: float = 0.5
    max_screen_size: float = 0.2
    patch_size: int = 128
    patch_num: int = 4
    lambda_patch_depth: float = 0.0
    # gs2dgs OptimizationParams overrides the 3DGS values for these
    lambda_isotropic: float = 0.0001
    dn_l1_weight_init: float = 0.2
    dn_l1_weight_final: float = 0.05


def save_cfg_args(model_path: str, args: Namespace):
    """Dump the merged namespace as `cfg_args` (reference-compatible repr)."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(Namespace(**vars(args))))


def parse_namespace_repr(text: str) -> Namespace:
    """Safely parse "Namespace(a=1, b='x')" without eval()."""
    tree = ast.parse(text.strip(), mode="eval")
    call = tree.body
    if not isinstance(call, ast.Call) or getattr(call.func, "id", "") != "Namespace":
        raise ValueError("cfg_args is not a Namespace(...) repr")
    kwargs = {}
    for kw in call.keywords:
        kwargs[kw.arg] = ast.literal_eval(kw.value)
    return Namespace(**kwargs)


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """Merge CLI args over the saved cfg_args of --model_path."""
    args_cmdline = parser.parse_args(argv if argv is not None else sys.argv[1:])
    merged = {}
    try:
        cfgfilepath = os.path.join(args_cmdline.model_path, "cfg_args")
        with open(cfgfilepath) as f:
            merged = vars(parse_namespace_repr(f.read()))
            print(f"Config file found: {cfgfilepath}")
    except (TypeError, FileNotFoundError, ValueError):
        pass
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)
