"""chip_smoke's phases at a tiny size on the CPU, and main() refusing a
CPU device. The GPU run itself is ``python chip_smoke.py`` on the card."""

import jax
import numpy as np
import pytest

import chip_smoke as cs
from mipsfusion_tpu.models import scene_rep as sr
from mipsfusion_tpu.slam.system import MIPSFusionTPU

TINY = cs.SizeProfile(
    orbit_frames=7, outback_frames=8, mesh_slab=2048, stage_reps=1,
    orbit_ate_max=0.2, outback_ate_max=1.0,
    overrides=(
        ("cam.H", 40), ("cam.W", 56), ("cam.fx", 28.0), ("cam.fy", 28.0),
        ("cam.cx", 27.5), ("cam.cy", 19.5),
        ("tracking.iter", 3), ("tracking.iter_RO", 2),
        ("tracking.sample", 96), ("tracking.ignore_edge_W", 4),
        ("tracking.ignore_edge_H", 4), ("tracking.RO.particle_size", 64),
        ("tracking.RO.n_rows", 8), ("tracking.RO.n_cols", 12),
        ("mapping.sample", 96), ("mapping.pixels_cur", 32),
        ("mapping.iters", 3), ("mapping.first_iters", 40),
        ("mapping.first_iters_chunk", 16), ("mapping.keyframe_every", 3),
        ("mapping.map_every", 2), ("mapping.overlapping.n_rays_h", 8),
        ("mapping.overlapping.n_rays_w", 8),
        ("sampling.kf_n_rays_h", 12), ("sampling.kf_n_rays_w", 16),
        ("training.n_samples_d", 8), ("training.n_range_d", 7),
        ("grid.tri_resolutions", [8, 16]), ("grid.cp_resolution", 24),
        ("grid.cp_components", 8), ("pos.n_bins", 2),
        ("decoder.hidden_dim", 32), ("decoder.geo_feat_dim", 16),
        ("decoder.hidden_dim_color", 16), ("mesh.voxel_final", 0.25),
        ("parallel.sharded_refine", False), ("parallel.dp_hot_path", False),
    ))


@pytest.fixture
def gpu_path(monkeypatch):
    """The GPU field path (for_platform's "gpu" choice) on the CPU."""
    choose = sr.for_platform
    monkeypatch.setattr(sr, "for_platform",
                        lambda cfg, platform: choose(cfg, "gpu"))


@pytest.fixture
def report():
    return cs.Report("test card, 0 W")


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_compile_stages_and_field_checks(gpu_path, report, capsys):
    slam = MIPSFusionTPU(cs.orbit_config(TINY))
    assert slam.fcfg.decoder.bf16
    stages = cs.compile_stages(slam, TINY, report)
    assert set(stages) == {"first_fit", "track_ro", "track_go",
                           "track_ro_go", "local_ba", "mesher_query"}
    out = capsys.readouterr().out
    assert out.count("compile ") == 6 and "[test card, 0 W]" in out
    res = cs.field_checks(slam, stages, TINY, report)
    assert res["ba_windows_differing"] <= cs.WINDOW_TOL
    assert res["ba_grad_rel"] <= cs.GRAD_TOL[0]
    assert res["ba_grad_cos"] >= cs.GRAD_TOL[1]
    assert "field query, mesher slab" in capsys.readouterr().out


def test_orbit_drive(report):
    slam = MIPSFusionTPU(cs.orbit_config(TINY))
    stages = cs.compile_stages(slam, TINY, report)
    res = cs.orbit_drive(stages, TINY, report)
    assert set(res["stage_ms"]) == {"track_ro", "track_go", "track_ro_go",
                                    "local_ba"}
    assert np.isfinite(res["ate"]) and res["fps"] > 0
    cs.check_orbit(res, TINY)


GOOD = {"ate": 0.01, "switch_backs": 1, "n_faces": 10}


@pytest.mark.parametrize("bad", [{"switch_backs": 0}, {"n_faces": 0},
                                 {"ate": 0.045}, {}])
def test_check_outback(bad):
    res = {**GOOD, **bad}
    if bad:
        with pytest.raises(cs.CheckFailed):
            cs.check_outback(res, cs.FULL)
    else:
        cs.check_outback(res, cs.FULL)


def test_check_orbit_bound():
    with pytest.raises(cs.CheckFailed):
        cs.check_orbit({"ate": 0.005, "ate_first_run": 0.02}, cs.FULL)
    cs.check_orbit({"ate": 0.005, "ate_first_run": 0.019}, cs.FULL)


def test_outback_drive_reports_mesh(report):
    res = cs.outback_drive(TINY, report)
    assert res["n_submaps"] >= 1 and res["devices"] == 1
    assert res["n_faces"] >= 0 and np.isfinite(res["ate"])


def test_dp_ba_check_on_four_devices(report):
    assert len(jax.devices()) >= 4
    cs.dp_ba_check(TINY, report, 4)


def test_sharded_refine_check_on_four_devices(report):
    cs.sharded_refine_check(TINY, report, 4)


def test_for_platform_choice():
    cfg = sr.FieldConfig(enc="Triplane")
    assert sr.for_platform(cfg, "cpu") == cfg      # plain f32 reference
    assert not cfg.decoder.bf16
    assert sr.for_platform(cfg, "gpu").decoder.bf16
    for platform in ("rocm", "metal", "cuda", ""):
        with pytest.raises(ValueError):
            sr.for_platform(cfg, platform)
