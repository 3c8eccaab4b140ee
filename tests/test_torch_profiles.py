"""The roofline half of ``repro_torch.core.profiles`` against ``repro``'s:
``RooflineTerms.step_time``, ``roofline_profile`` and ``elasticity_of`` bit
for bit on drawn terms (drawn as ``tests/test_property_engine.py`` draws
them), and ``terms_from_dryrun`` / ``profile_from_dryrun`` on planted cells:
a reference cell (no rates: the reference's terms exactly) and a cell of the
port (its rates used)."""
import dataclasses
import json

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import profiles as ref
from repro_torch.core import profiles
from repro_torch.launch import dryrun

TERMS = dict(flops=st.floats(min_value=1e10, max_value=1e16),
             hbm=st.floats(min_value=1e8, max_value=1e14),
             grad=st.floats(min_value=1e5, max_value=1e12))


def _same_profile(make_ref, make_port):
    try:
        want = make_ref()
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            make_port()
        return
    got = make_port()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert profiles.elasticity_of(got) == ref.elasticity_of(want)


@given(**TERMS, k_max=st.integers(1, 16), k_min=st.integers(1, 4))
@settings(max_examples=60, deadline=None)
def test_roofline_bit_for_bit(flops, hbm, grad, k_max, k_min):
    k_max = max(k_max, k_min)
    r = ref.RooflineTerms(flops=flops, hbm_bytes=hbm, grad_bytes=grad)
    p = profiles.RooflineTerms(flops=flops, hbm_bytes=hbm, grad_bytes=grad)
    assert dataclasses.astuple(p) == dataclasses.astuple(r)
    for k in range(1, 17):
        assert p.step_time(k) == r.step_time(k)
    _same_profile(lambda: ref.roofline_profile(r, k_min, k_max),
                  lambda: profiles.roofline_profile(p, k_min, k_max))


@given(**TERMS, peak=st.floats(1e12, 1e16), bw=st.floats(1e10, 1e13),
       link=st.floats(1e9, 1e12))
@settings(max_examples=30, deadline=None)
def test_roofline_bit_for_bit_with_rates(flops, hbm, grad, peak, bw, link):
    kw = dict(flops=flops, hbm_bytes=hbm, grad_bytes=grad, peak_flops=peak, hbm_bw=bw,
              link_bw=link)
    r, p = ref.RooflineTerms(**kw), profiles.RooflineTerms(**kw)
    _same_profile(lambda: ref.roofline_profile(r), lambda: profiles.roofline_profile(p))


def test_field_order_and_defaults():
    assert [(f.name, f.default) for f in dataclasses.fields(profiles.RooflineTerms)] == \
        [(f.name, f.default) for f in dataclasses.fields(ref.RooflineTerms)]


def _plant(tmp_path, arch, cell, shape="train_4k", mesh="16x16"):
    d = tmp_path / "cells"
    d.mkdir(exist_ok=True)
    (d / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(cell))
    return str(d)


# a reference-format cell: the fields terms_from_dryrun reads, no rates
REF_CELLS = {
    "llama3-8b": {"chips": 256, "hlo_stats": {"flops": 2.613e14, "hbm_bytes": 4.1e12},
                  "params_active": 8_030_261_248},
    "dbrx-132b": {"chips": 512, "hlo_stats": {"flops": 7.44e14, "hbm_bytes": 9.0e12},
                  "params_active": 36_000_000_000},
}


@pytest.mark.parametrize("arch", sorted(REF_CELLS))
@pytest.mark.parametrize("kw", [{}, dict(tokens_per_step=16_384), dict(k_min=2, k_max=8)])
def test_reference_cell_equal(tmp_path, arch, kw):
    d = _plant(tmp_path, arch, REF_CELLS[arch])
    k = {n: kw[n] for n in ("k_min", "k_max") if n in kw}
    t = {n: v for n, v in kw.items() if n not in k}
    want = ref.terms_from_dryrun(arch, dryrun_dir=d, **t)
    got = profiles.terms_from_dryrun(arch, dryrun_dir=d, **t)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    _same_profile(lambda: ref.profile_from_dryrun(arch, dryrun_dir=d, **kw),
                  lambda: profiles.profile_from_dryrun(arch, dryrun_dir=d, **kw))


def test_other_shape_and_missing_file(tmp_path):
    d = _plant(tmp_path, "llama3-8b", REF_CELLS["llama3-8b"], shape="prefill_32k")
    kw = dict(dryrun_dir=d, shape="prefill_32k")
    assert dataclasses.astuple(profiles.terms_from_dryrun("llama3-8b", **kw)) == \
        dataclasses.astuple(ref.terms_from_dryrun("llama3-8b", **kw))
    for mod in (ref, profiles):
        with pytest.raises(FileNotFoundError):
            mod.terms_from_dryrun("zamba2-7b", dryrun_dir=d)


def test_port_cell_carries_its_rates(tmp_path):
    """A cell the port's dry-run writes: its rates reach RooflineTerms; the
    same cell without them gives the reference's terms."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.common import ShapeConfig

    cfg = reduced(ARCHS["llama3-8b"])
    cell = dryrun.cell_record("llama3-8b", cfg, ShapeConfig("train_4k", 64, 2, "train"),
                              dryrun.make_production_mesh(),
                              dryrun.count_cell(cfg, ShapeConfig("train_4k", 64, 2, "train")), 0.0)
    cell = json.loads(json.dumps(cell))
    d = _plant(tmp_path, "llama3-8b", cell)
    got = profiles.terms_from_dryrun("llama3-8b", dryrun_dir=d)
    assert (got.peak_flops, got.hbm_bw, got.link_bw) == (989e12, 3.35e12, 50e9)
    scale = 65_536 / (256 * 4096)
    assert got.flops == cell["hlo_stats"]["flops"] * 16 * scale
    assert got.grad_bytes == 2.0 * cell["params_active"] / 16
    want = ref.terms_from_dryrun("llama3-8b", dryrun_dir=d)
    assert dataclasses.astuple(dataclasses.replace(
        got, peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)) == dataclasses.astuple(want)
    prof = profiles.profile_from_dryrun("llama3-8b", dryrun_dir=d)
    np.testing.assert_array_equal(prof, profiles.roofline_profile(got))
    assert prof[0] == 1.0 and (np.diff(prof) <= 1e-12).all()
