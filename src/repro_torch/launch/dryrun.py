"""Dry-run of every (architecture × input shape × mesh) step on H100s: the
roofline record of one step, counted without running anything (the port
of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --out dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh-shape host

The reference compiles each step for 512 placeholder CPU devices. The port
runs each step eagerly on ``meta`` tensors
(:mod:`repro_torch.launch.specs`) under the per-op counter
(:mod:`repro_torch.roofline.op_cost`), in a one-process world of the
mesh's size on torch's ``fake`` process-group backend: this process is
rank 0 of 256 for ``16x16``, of 512 for ``2x16x16``, of the product for
``--mesh-shape``, and its collectives move nothing. The world is torn down
and built again between meshes. ``--mesh-shape host`` counts the program
meshless (chips 1), which is what ``--mesh host`` means on the launchers.
The figures are counts divided by the H100's constants
(:mod:`repro_torch.roofline.analysis`): projections, not measurements.
The kernels are counted by their own work, as the card would launch them
(:mod:`repro_torch.kernels.kernel_cost`).

An error is a fault of the port: the record says so, and the run exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.config import INPUT_SHAPES, arch_supports_shape, get_arch, list_archs
from repro_torch.launch.specs import DRYRUN_TC, build_coboost_program, build_program
from repro_torch.roofline import roofline_report
from repro_torch.roofline.op_cost import count_step
from repro_torch.sharding.partition import mesh_context
from repro_torch.utils.logging import get_logger

log = get_logger("dryrun")

_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
_MESHES: Dict[str, Any] = {}


def _parse_value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    return v


def mesh_dims(name: str) -> tuple:
    """The mesh shape a name gives (``"16x16"``, ``"2x32x8"``; ``"host"`` is
    ``()``)."""
    return () if name == "host" else tuple(int(d) for d in name.split("x"))


def fake_world(size: int) -> None:
    """A one-process world of ``size`` ranks on the ``fake`` backend, this
    process rank 0; the group in place is kept when its size is ``size``,
    else torn down first. ``size`` 1 needs no group. A mesh built on a world
    that was torn down and built again fails (torch keeps its groups'
    names), so a run counts one mesh at a time and builds each once."""
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    _MESHES.clear()  # a mesh lives as long as the group it was built on
    if size > 1:
        # the fake backend registers itself when this module is imported; it
        # lives under torch.testing, so it is imported here and nowhere else
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def dryrun_mesh(name: str):
    """The mesh a name gives, over a fake world of its size (None for
    ``host``): a ``DeviceMesh`` on CPU ranks with the reference's axis
    names. The tensors it places are on ``meta``."""
    from torch.distributed.device_mesh import DeviceMesh

    dims = mesh_dims(name)
    n = 1
    for d in dims:
        n *= d
    fake_world(n)
    if not dims:
        return None
    if name not in _MESHES:
        _MESHES[name] = DeviceMesh("cpu", torch.arange(n).reshape(dims), mesh_dim_names=_AXES[len(dims)])
    return _MESHES[name]


def dryrun_one(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    verbose: bool = True,
    coboost_clients: int = 0,
    overrides: Optional[Dict[str, Any]] = None,
    tc_overrides: Optional[Dict[str, Any]] = None,
    mesh_shape: str = "",
    kl_chunk: int = 0,
) -> Dict[str, Any]:
    """Count one (arch, shape, mesh) step; returns the roofline record (or a
    skip record). ``coboost_clients > 0`` counts the paper-technique
    ensemble-distillation step instead of the plain step.
    ``overrides``/``tc_overrides``/``mesh_shape``/``kl_chunk`` are the
    reference's hill-climb levers."""
    cfg = get_arch(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    tc = dataclasses.replace(DRYRUN_TC, **tc_overrides) if tc_overrides else DRYRUN_TC
    shape = INPUT_SHAPES[shape_name]
    mesh_name = mesh_shape or ("2x16x16" if multi_pod else "16x16")
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if coboost_clients:
        rec["coboost_clients"] = coboost_clients
    if overrides:
        rec["overrides"] = overrides
    if tc_overrides:
        rec["tc_overrides"] = tc_overrides
    if kl_chunk:
        rec["kl_chunk"] = kl_chunk
    skip = arch_supports_shape(cfg, shape)
    if skip:
        rec.update(status="skip", reason=skip)
        return rec
    mesh = dryrun_mesh(mesh_name)
    chips = 1 if mesh is None else mesh.size()
    t0 = time.time()
    with mesh_context(mesh):
        if coboost_clients:
            fn, args = build_coboost_program(cfg, shape, coboost_clients, tc=tc, kl_chunk=kl_chunk)
        else:
            fn, args = build_program(cfg, shape, tc=tc)
        t_build = time.time() - t0
        counts = count_step(fn, args)
    report = roofline_report(counts, chips, cfg, shape)
    rec.update(status="ok", kind=shape.kind, build_s=round(t_build, 1), count_s=round(time.time() - t0 - t_build, 1),
               **report)
    if verbose:
        print(json.dumps({k: counts[k] for k in ("flops", "bytes", "collectives", "argument_bytes", "temp_bytes")}))
        print(json.dumps(counts["kernels"]))
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default=None, help="architecture id (see --list)")
    p.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    p.add_argument("--all", action="store_true", help="every (arch, shape) pair")
    p.add_argument("--multi-pod", default="single", choices=("single", "multi", "both"))
    p.add_argument("--out", default=None, help="write the JSON records here")
    p.add_argument("--list", action="store_true")
    p.add_argument("--coboost", type=int, default=0, metavar="K",
                   help="count the K-client Co-Boosting distillation step instead")
    p.add_argument("--override", action="append", default=[], metavar="K=V",
                   help="ModelConfig field override (e.g. num_layers=2)")
    p.add_argument("--tc-override", action="append", default=[], metavar="K=V",
                   help="TrainConfig field override (e.g. state_dtype=bfloat16)")
    p.add_argument("--mesh-shape", default="",
                   help="custom mesh, e.g. 32x8 or 2x32x8; 'host' counts the meshless program (chips 1)")
    p.add_argument("--kl-chunk", type=int, default=0, help="chunked distill-KL (coboost)")
    args = p.parse_args(argv)
    overrides = {k: _parse_value(v) for k, v in (kv.split("=", 1) for kv in args.override)}
    tc_overrides = {k: _parse_value(v) for k, v in (kv.split("=", 1) for kv in args.tc_override)}

    if args.list:
        for a in list_archs():
            print(a)
        return

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]
    # one mesh at a time, so that each fake world is built once
    pairs = [(a, s, mp) for mp in meshes for a in archs for s in shapes]

    records = []
    n_ok = n_skip = n_err = 0
    t_all = time.time()
    for a, s, mp in pairs:
        mesh_name = args.mesh_shape or ("2x16x16" if mp else "16x16")
        label = f"{a} × {s} × {mesh_name}"
        try:
            rec = dryrun_one(
                a, s, multi_pod=mp, verbose=not args.all, coboost_clients=args.coboost,
                overrides=overrides, tc_overrides=tc_overrides,
                mesh_shape=args.mesh_shape, kl_chunk=args.kl_chunk,
            )
        except Exception as e:  # a failure here is a fault of the port
            rec = {"arch": a, "shape": s, "mesh": mesh_name, "status": "error", "error": f"{type(e).__name__}: {e}"}
            traceback.print_exc()
        records.append(rec)
        if rec["status"] == "ok":
            n_ok += 1
            log.info("%s OK count=%.1fs dominant=%s bound=%.4fs fits=%s", label, rec["count_s"], rec["dominant"],
                     rec["bound_s"], rec["fits_hbm"])
        elif rec["status"] == "skip":
            n_skip += 1
            log.info("%s SKIP (%s)", label, rec["reason"])
        else:
            n_err += 1
            log.error("%s ERROR %s", label, rec["error"])
        if args.out:
            with open(args.out, "w") as f:
                json.dump(records, f, indent=1)
    log.info("dry-run done: %d ok, %d skip, %d error in %.1f s", n_ok, n_skip, n_err, time.time() - t_all)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
