"""The port's per-op backend policy (``repro_torch.kernels.dispatch``),
ported from ``tests/test_backend_policy.py`` as far as the policy reaches,
with the port's values (``auto | cuda | ref``): ``resolve``'s rules,
``BackendPolicy``'s per-op fallback (held against the reference's) and
validation, the policy on ``ModelConfig`` and ``OFLConfig`` (a plain string
``backend=`` still builds hashable configs), the launchers' ``--backend``
reaching the run's config, and each op's policy steering its own call
site. The port has no deprecated per-op aliases: the policy is the one way
to set a backend."""
from __future__ import annotations

import dataclasses
import itertools

import pytest
import torch

from repro.kernels.dispatch import BackendPolicy as JaxBackendPolicy
from repro_torch.config.model import ModelConfig
from repro_torch.config.train import OFLConfig
from repro_torch.kernels import BACKEND_OPS, KERNEL_BACKENDS, BackendPolicy, resolve

pytestmark = pytest.mark.tier1

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# resolve()


@pytest.mark.parametrize("op", BACKEND_OPS)
def test_resolve_by_device(op):
    assert resolve(op, "auto", CPU) == "fused"  # the wrappers' plain versions on CPU tensors
    assert resolve(op, "auto", torch.device("cuda")) == "fused"
    assert resolve(op, "ref", CPU) == "ref"
    assert resolve(op, "cuda", torch.device("cuda")) == "fused"
    with pytest.raises(ValueError, match="requires CUDA tensors"):
        resolve(op, "cuda", CPU)


def test_resolve_validates_op_and_backend():
    assert KERNEL_BACKENDS == ("auto", "cuda", "ref")
    with pytest.raises(ValueError, match="unknown backend op"):
        resolve("matmul", "auto", CPU)
    with pytest.raises(ValueError, match="unknown kernel backend"):
        resolve("loss", "pallas", CPU)


# ---------------------------------------------------------------------------
# BackendPolicy


def test_policy_per_op_fallback():
    pol = BackendPolicy(default="ref", attn="cuda")
    assert pol.for_op("attn") == "cuda"
    assert pol.for_op("loss") == "ref"
    assert pol.for_op("decode") == "ref"
    assert resolve("loss", pol.for_op("loss"), CPU) == "ref"
    assert resolve("attn", pol.for_op("attn"), torch.device("cuda")) == "fused"
    assert dataclasses.replace(pol, decode="auto").for_op("decode") == "auto"


def test_policy_fallback_matches_jax():
    """Over every mix of the values both packages take (``auto``, ``ref``,
    unset), each op's choice equals the reference policy's."""
    for default, *ops in itertools.product(("auto", "ref"), *[("", "auto", "ref")] * len(BACKEND_OPS)):
        kw = dict(zip(BACKEND_OPS, ops))
        pol, jpol = BackendPolicy(default=default, **kw), JaxBackendPolicy(default=default, **kw)
        assert [pol.for_op(op) for op in BACKEND_OPS] == [jpol.for_op(op) for op in BACKEND_OPS], kw


def test_policy_validates_on_construction():
    with pytest.raises(ValueError, match="unknown kernel backend"):
        BackendPolicy(default="pallas")
    with pytest.raises(ValueError, match="unknown loss kernel backend"):
        BackendPolicy(loss="jnp")
    with pytest.raises(ValueError, match="unknown backend op"):
        BackendPolicy().for_op("matmul")


# ---------------------------------------------------------------------------
# the configs carry the policy


def test_configs_carry_the_policy():
    """Both configs default to ``auto`` for every op, read an explicit
    policy op by op, and refuse a bad value or type at construction."""
    for cfg in (ModelConfig(name="t"), OFLConfig()):
        assert cfg.backend == BackendPolicy() and all(cfg.backend_for(op) == "auto" for op in BACKEND_OPS)
    m = ModelConfig(name="t", backend=BackendPolicy(attn="cuda", decode="ref"))
    assert (m.backend_for("attn"), m.backend_for("decode"), m.backend_for("loss")) == ("cuda", "ref", "auto")
    m.validate()
    assert OFLConfig(backend=BackendPolicy(loss="ref")).backend_for("loss") == "ref"
    with pytest.raises(ValueError, match="unknown decode kernel backend"):
        ModelConfig(name="t", backend=BackendPolicy(decode="pallas"))
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ModelConfig(name="t", backend="pallas")
    with pytest.raises(TypeError, match="BackendPolicy"):
        OFLConfig(backend=None)


def test_string_backend_builds_hashable_configs():
    """A plain string ``backend=`` means that value for every op, is held
    as a policy, and keeps both configs frozen, hashable and equal to
    themselves."""
    m = ModelConfig(name="t", backend="ref")
    assert m.backend == BackendPolicy(default="ref")
    assert all(m.backend_for(op) == "ref" for op in BACKEND_OPS)
    assert m == ModelConfig(name="t", backend=BackendPolicy(default="ref"))
    assert hash(m) == hash(ModelConfig(name="t", backend="ref"))
    assert m.replace(backend="cuda").backend_for("decode") == "cuda"
    o = OFLConfig(backend="ref")
    assert o.backend == BackendPolicy(default="ref") and o.backend_for("loss") == "ref"
    assert hash(o) == hash(OFLConfig(backend="ref")) and o == OFLConfig(backend=BackendPolicy(default="ref"))
    assert {m: 1}[ModelConfig(name="t", backend="ref")] == 1
    with pytest.raises(TypeError, match="BackendPolicy"):
        ModelConfig(name="t", backend=3)


# ---------------------------------------------------------------------------
# the launchers' --backend


@pytest.mark.parametrize("argv, want", [(["--backend", "ref"], BackendPolicy(default="ref")), ([], BackendPolicy())])
def test_serve_backend_flag_reaches_the_model_config(argv, want):
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(argv)
    assert ModelConfig(name="t").replace(backend=args.backend).backend == want


class _Built(Exception):
    """Raised right after the run's OFLConfig is built, carrying it."""


def test_ofl_backend_flag_reaches_the_run_config(monkeypatch):
    """``--backend`` reaches the run's OFLConfig as the policy default."""
    from repro_torch.launch import ofl

    def stop(*args, **kwargs):
        raise _Built()

    built = []
    monkeypatch.setattr(ofl, "OFLConfig", lambda **kw: built.append(OFLConfig(**kw)))
    monkeypatch.setattr(ofl, "make_synth_images", stop)
    for argv, want in ((["--backend", "ref"], BackendPolicy(default="ref")), ([], BackendPolicy())):
        with pytest.raises(_Built):
            ofl.prepare_run(ofl.parse_args(argv), CPU)
        assert built.pop().backend == want


@pytest.mark.parametrize("op, stage", [("attn", "admit"), ("decode", "decode_chunk")])
def test_policy_steers_each_op_at_its_call_site(op, stage):
    """The model's call sites read ``cfg.backend_for(op)``: a policy that
    asks for the kernels of one op alone (``"cuda"``, refused on CPU
    tensors) stops the engine exactly where that op first runs, prefill for
    ``"attn"`` and the paged decode chunk for ``"decode"``."""
    import numpy as np

    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = ModelConfig(name="t", num_layers=1, d_model=32, num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
                      vocab_size=64, dtype="float32", backend=BackendPolicy(**{op: "cuda"}))
    eng = ServeEngine(cfg, init_lm(cfg, torch.Generator().manual_seed(0)),
                      EngineConfig(max_slots=1, max_seq=32, max_new=4, decode_chunk=2, prefill_bucket=8, page_size=8))
    with pytest.raises(ValueError, match=f"{op} backend 'cuda' requires CUDA tensors"):
        eng.admit(np.arange(5, dtype=np.int32), 4)
        assert stage == "decode_chunk"  # admission passed: only the decode op asks for the kernels
        eng.decode_chunk()
