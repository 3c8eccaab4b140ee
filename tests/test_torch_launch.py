"""The port's launch layer against ``repro``'s: the cell matrix, the shapes,
the meta templates against the reference's ShapeDtypeStruct templates on a
1×1 mesh, ``model_flops``, the production meshes, and the dry-run's counts
against ``repro.launch.dryrun.lower_cell`` + ``analyze_module`` on reduced
configs.

The counted FLOPs (``torch.utils.flop_counter``'s matmul formulas over the
ops a step dispatches on ``meta``) against the reference's HLO dots, at the
shapes below (measured on this tree, reduced llama3-8b, qwen3-moe, rwkv6,
zamba2):

- prefill: equal;
- decode at a 2048-token cache (a whole number of the reference's
  2048-key decode chunks; a shorter cache is padded to 2048 keys there and
  cut short here): equal;
- train: the reference's count plus one product of the loss head over the
  padded CE chunk: ``torch.utils.checkpoint`` recomputes each CE chunk's
  logits in the backward, and XLA drops that recompute of a
  ``jax.checkpoint`` scan body.  Within 0.5 % of the reference's count
  after that (dense and MoE: 0; rwkv6 and zamba2: -0.16 % and -0.10 %).

Bytes differ by design (eager counting fuses nothing, XLA's count is of
buffers after fusion): the ratio is printed and held within [0.15, 5]
(readings 0.34-3.25).
"""
import dataclasses
import functools
import math
import os

import jax
import numpy as np
import pytest
import torch

jax.devices()                 # the backend first: the reference's dry-run sets XLA_FLAGS
_saved = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402
if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import LONG_CONTEXT_ARCHS as REF_LONG  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.launch.hlo_analysis import analyze_module  # noqa: E402
from repro.launch.mesh import make_abstract_mesh  # noqa: E402
from repro.launch.mesh import make_mesh as ref_make_mesh  # noqa: E402
from repro.models import SHAPES as REF_SHAPES  # noqa: E402
from repro.models import LogicalRules  # noqa: E402
from repro.models.common import ShapeConfig as RefShape  # noqa: E402

from repro_torch.configs import ARCHS, LONG_CONTEXT_ARCHS, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import dryrun, mesh, op_analysis  # noqa: E402
from repro_torch.models import SHAPES, ShapeConfig  # noqa: E402


@pytest.fixture(scope="module")
def rules():
    return LogicalRules(ref_make_mesh((1, 1), ("data", "model")))


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype) else np.dtype(dtype).name


def _same_tree(port, ref):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for key in ref:
            _same_tree(port[key], ref[key])
        return
    assert tuple(port.shape) == tuple(ref.shape)
    assert _dtype_name(port.dtype) == _dtype_name(ref.dtype)
    assert port.device.type == "meta"


# --------------------------------------------------------------------------
# the cell matrix, shapes, meshes


def test_40_cell_grid_32_runnable():
    assert len(ARCHS) * len(SHAPES) == 40
    live = [(a, s) for a in ARCHS for s in SHAPES if dryrun.runnable(a, SHAPES[s])]
    assert len(live) == 32
    assert live == [(a, s) for a in REF_ARCHS for s in REF_SHAPES
                    if ref_dryrun.runnable(a, REF_SHAPES[s])]


def test_long_context_archs_and_shapes_equal():
    assert LONG_CONTEXT_ARCHS == REF_LONG
    assert list(SHAPES) == list(REF_SHAPES)
    for name in SHAPES:
        assert dataclasses.astuple(SHAPES[name]) == dataclasses.astuple(REF_SHAPES[name])
    assert [f.name for f in dataclasses.fields(ShapeConfig)] == \
        [f.name for f in dataclasses.fields(RefShape)]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    m = mesh.make_production_mesh(multi_pod=multi_pod)
    want = make_abstract_mesh(m.shape, m.axes)
    assert dict(zip(m.axes, m.shape)) == dict(want.shape)
    assert m.devices == (512 if multi_pod else 256)
    assert m.axes == (("pod", "data", "model") if multi_pod else ("data", "model"))
    assert mesh.make_mesh((4,), ("data",)).devices == 4
    with pytest.raises(ValueError):
        mesh.make_mesh((2, 2), ("data",))


# --------------------------------------------------------------------------
# the meta templates against the reference's


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_templates_equal_reference(arch, rules):
    from repro.models.api import abstract_params as ref_abstract_params
    from repro.serve import abstract_cache as ref_abstract_cache
    from repro.serve import serve_input_specs as ref_serve_input_specs
    from repro.train import abstract_state as ref_abstract_state
    from repro.train import batch_specs as ref_batch_specs

    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    _same_tree(dryrun.abstract_params(cfg), ref_abstract_params(rcfg, rules))
    st, rst = dryrun.abstract_state(cfg), ref_abstract_state(rcfg, rules)
    for part in ("params", "m", "v"):
        _same_tree(getattr(st, part), getattr(rst, part))
    for name in SHAPES:
        shape = SHAPES[name]
        if not dryrun.runnable(arch, shape):
            continue
        if shape.kind in ("train", "prefill"):
            _same_tree(dryrun.batch_specs(cfg, shape), ref_batch_specs(rcfg, shape, rules))
            _same_tree(dryrun.input_specs(arch, name), ref_batch_specs(rcfg, shape, rules))
        else:
            b = shape.global_batch
            _same_tree(dryrun.serve_input_specs(cfg, b), ref_serve_input_specs(rcfg, b, rules))
            _same_tree(dryrun.abstract_cache(cfg, b, shape.seq_len),
                       ref_abstract_cache(rcfg, b, shape.seq_len, rules))
            specs = dryrun.input_specs(arch, name)
            _same_tree(specs["tokens"], ref_serve_input_specs(rcfg, b, rules))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_and_params_equal(arch):
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    assert (cfg.param_count(), cfg.active_param_count()) == \
        (rcfg.param_count(), rcfg.active_param_count())
    for name, shape in SHAPES.items():
        # the reference's expression in analyze_cell
        n_active = rcfg.active_param_count()
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        want = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
        assert dryrun.model_flops(cfg, shape) == want


# --------------------------------------------------------------------------
# counts against the reference's HLO


def _ref_count(arch, shape):
    lowered, hints = ref_dryrun.lower_cell(ref_reduced(REF_ARCHS[arch]),
                                           RefShape(*dataclasses.astuple(shape)),
                                           ref_make_mesh((1, 1), ("data", "model")))
    return analyze_module(lowered.compile().as_text(), scan_trip_hints=hints)


COUNT_SHAPES = {"train": ShapeConfig("t", 128, 4, "train"),
                "prefill": ShapeConfig("p", 128, 4, "prefill"),
                "decode": ShapeConfig("d", 2048, 2, "decode")}
TRAIN_TOL = 5e-3
BYTES_RATIO = (0.15, 5.0)


@pytest.mark.parametrize("kind", sorted(COUNT_SHAPES))
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-235b-a22b", "rwkv6-7b", "zamba2-7b"])
def test_counted_flops_against_reference(arch, kind):
    shape = COUNT_SHAPES[kind]
    cfg = reduced(ARCHS[arch])
    want = _ref_count(arch, shape)
    got = dryrun.count_cell(cfg, shape)
    ratio = got.bytes / want.hbm_bytes
    print(f"{arch} {kind}: FLOPs {got.flops:.6e} (reference {want.flops:.6e}), "
          f"bytes {got.bytes:.6e} (reference {want.hbm_bytes:.6e}, ratio {ratio:.3f})")
    assert BYTES_RATIO[0] <= ratio <= BYTES_RATIO[1]
    if kind != "train":
        assert got.flops == want.flops
        return
    # one more product of the loss head: the CE chunk's recomputed logits
    ce_positions = math.ceil((shape.seq_len - cfg.prefix_len - 1) / 512) * 512
    head = 2 * shape.global_batch * ce_positions * cfg.d_model * cfg.vocab_size
    assert abs(got.flops - head - want.flops) <= TRAIN_TOL * want.flops


# --------------------------------------------------------------------------
# the repeat-count fit against the full count


@pytest.mark.parametrize("kind", sorted(COUNT_SHAPES))
@pytest.mark.parametrize("arch,layers", [("llama3-8b", 6), ("qwen3-moe-235b-a22b", 5),
                                         ("rwkv6-7b", 5), ("zamba2-7b", 13),
                                         ("internvl2-2b", 4)])
def test_fit_equals_full_count(arch, layers, kind):
    cfg = dataclasses.replace(reduced(ARCHS[arch]), num_layers=layers)
    shape = dataclasses.replace(COUNT_SHAPES[kind], seq_len=64) if kind != "decode" \
        else ShapeConfig("d", 128, 2, "decode")
    assert len(dryrun.fit_tasks(cfg)) == 3
    full, fit = dryrun.count_step(cfg, shape), dryrun.count_cell(cfg, shape)
    assert (fit.flops, fit.bytes, fit.ops) == (full.flops, full.bytes, full.ops)
    assert fit.by_op == full.by_op


@pytest.mark.parametrize("kind", sorted(COUNT_SHAPES))
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "zamba2-7b", "internvl2-2b"])
def test_memo_counts_what_running_counts(arch, kind, monkeypatch):
    """The counter's memo (a functional op on the same shapes not run
    again) changes no count."""
    cfg, shape = reduced(ARCHS[arch]), COUNT_SHAPES[kind]
    counts = []
    for memo in (True, False):
        monkeypatch.setattr(dryrun, "count", functools.partial(op_analysis.count, memo=memo))
        counts.append(dryrun.count_step(cfg, shape))
    a, b = counts
    assert (a.flops, a.bytes, a.ops, a.by_op) == (b.flops, b.bytes, b.ops, b.by_op)


def test_fit_repeats():
    z = ARCHS["zamba2-7b"]
    n, at = dryrun.repeats(z)
    assert n == 13 and [at(k).num_layers for k in (1, 2, 3)] == [9, 15, 21]
    n, at = dryrun.repeats(ARCHS["llama3-8b"])
    assert n == 32 and at(2).num_layers == 2
    small = reduced(ARCHS["llama3-8b"])
    assert dryrun.fit_tasks(small) == [small]


def test_count_cells_in_processes():
    cells = [(reduced(ARCHS["stablelm-1.6b"]), ShapeConfig("t", 64, 2, "train")),
             (dataclasses.replace(reduced(ARCHS["llama3-8b"]), num_layers=4),
              ShapeConfig("p", 64, 2, "prefill"))]
    serial = dryrun.count_cells(cells)
    pooled = dryrun.count_cells(cells, workers=2)
    for (a, _), (b, _) in zip(serial, pooled):
        assert (a.flops, a.bytes, a.ops, a.by_op) == (b.flops, b.bytes, b.ops, b.by_op)
    assert all(s > 0 for _, s in pooled)


# --------------------------------------------------------------------------
# the flash route on meta: one kernel a call, its work reported


def test_flash_meta_route_counts_its_kernels():
    cfg = dataclasses.replace(reduced(ARCHS["llama3-8b"]), compute_dtype=torch.bfloat16)
    shape = ShapeConfig("t", 64, 2, "train")
    stats = dryrun.count_step(cfg, shape, attention="flash")
    L = cfg.num_layers
    fwd, bwd = stats.by_op["gqa_flash"], stats.by_op["gqa_flash_bwd"]
    assert (fwd[0], bwd[0]) == (2 * L, L)     # forward and its recompute; one backward
    hd, b, s = cfg.resolved_head_dim, shape.global_batch, shape.seq_len
    q = torch.empty((b, s, cfg.num_heads, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, s, cfg.num_kv_heads, hd), dtype=torch.bfloat16, device="meta")
    pairs = s * (s + 1) // 2
    assert fa.kernel_work(q, k, 0, False)[0] == 2 * 2 * hd * cfg.num_heads * b * pairs
    route_products = 8 if fa.bwd_route(torch.bfloat16, hd) == "fma" else 7
    assert fa.kernel_work(q, k, 0, True)[0] == route_products * 2 * hd * cfg.num_heads * b * pairs
    assert fwd[1] == 2 * L * fa.kernel_work(q, k, 0, False)[0]
    assert "bmm" not in " ".join(stats.by_op)           # no attention product left in torch
    chunked = dryrun.count_step(cfg, shape)
    assert "gqa_flash" not in chunked.by_op
    # outside a counter the meta route returns shapes and counts nothing
    out = fa.gqa_flash(q, k, k)
    assert out.shape == q.shape and out.device.type == "meta"


def test_counter_bytes_rule():
    with op_analysis.OpCounter() as c:
        x = torch.empty((4, 8), device="meta")
        y = x + 1.0                               # 128 read, 128 written
        _ = y.t()                                 # a view: nothing
        z = torch.ones(8, device="meta").expand(4, 8) * y   # the broadcast read once
        _ = z @ torch.empty((8, 3), device="meta")
    # add; ones (written); mul (the broadcast's 8 elements, y, out); mm
    assert c.stats.bytes == (128 + 128) + 32 + (32 + 128 + 128) + (128 + 96 + 48)
    assert c.stats.flops == 2 * 4 * 8 * 3
    assert c.stats.by_op["aten.t"][2] == 0


# --------------------------------------------------------------------------
# the CLI and its cells


def test_cli_cell_fields_and_default_out(tmp_path, capsys):
    from repro_torch.core.profiles import terms_from_dryrun

    assert dryrun.DEFAULT_OUT != "results/dryrun_opt"
    dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert "all dry-run cells passed" in capsys.readouterr().out
    import json
    cell = json.loads((tmp_path / "stablelm-1.6b__decode_32k__16x16.json").read_text())
    for key in ("arch", "shape", "kind", "mesh", "chips", "hlo_stats", "collectives",
                "roofline", "params_total", "params_active"):
        assert key in cell
    assert (cell["arch"], cell["shape"], cell["kind"], cell["mesh"], cell["chips"]) == \
        ("stablelm-1.6b", "decode_32k", "decode", "16x16", 256)
    # one device's counts: rank 0's program of the sharded decode step and
    # the collectives it asks for, in the reference's fields
    coll = cell["collectives"]
    assert coll["payload_bytes"] > 0 and coll["count"] > 0
    assert set(coll["by_type"]) <= {"all-reduce", "all-gather"}
    assert sum(coll["by_type"].values()) == coll["payload_bytes"]
    wire = sum(nb * (2 * (int(k.split("/")[1]) - 1) if k.startswith("all-reduce")
                     else int(k.split("/")[1]) - 1) / int(k.split("/")[1])
               for k, (_, nb) in coll["by_group"].items())
    assert coll["wire_bytes"] == pytest.approx(wire, rel=1e-12)
    assert cell["hlo_stats"]["flops"] == cell["counted"]["flops"]
    assert "16x16" in cell["counted"]["split"]
    r = cell["roofline"]
    assert r["compute_s"] == cell["hlo_stats"]["flops"] / 989e12
    assert r["memory_s"] == cell["hlo_stats"]["hbm_bytes"] / 3.35e12
    assert r["collective_s"] == coll["wire_bytes"] / 50e9
    assert r["dominant"] in ("compute", "memory", "collective")
    t = terms_from_dryrun("stablelm-1.6b", dryrun_dir=str(tmp_path), shape="decode_32k")
    assert t.peak_flops == 989e12 and t.grad_bytes == 2.0 * cell["params_active"] / 16
    # --skip-existing leaves the cell
    dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--out", str(tmp_path),
                 "--skip-existing"])
    assert "CACHED stablelm-1.6b__decode_32k__16x16" in capsys.readouterr().out
