"""The video cell (`video_cif.fit`) at a small size on the CPU: the
harness's run with everything but the look for a card, sound, with the
timed path broken underneath, and with the TF32 reference in the
program's place; the traced run's readers; `video.reseed_ms` on made
slices; and the clip the configuration names."""

import os

import numpy as np
import pytest

import run
from yardstick import trace as tr
from yardstick import video_content

CELL = "video_cif.fit"
# a 24 x 32 x 4 clip (too small for the moving square) in 4 blocks of
# 24 x 16 x 2, [3, 3, 2] kernels: the recipe's phases, each cut short
SMALL = {
    "config": {"content": {"family": "cif_video", "height": 24,
                           "width": 32, "frames": 4, "shift": 1.0,
                           "moving_obj": False},
               "kernels_per_dim": [3, 3, 2], "blocks": 4,
               "block_shape": [24, 16, 2], "iterations": 10,
               "val_iter": 5, "ls_refresh_iter": 5, "reseed_iterations": 4,
               "reseed_val_iter": 5},
    "traffic": {"sweeps_per_call": 5, "val_iter": 5}}


def small(**extra):
    return dict({k: dict(v) for k, v in SMALL.items()}, **extra)


def driver():
    return run.load_module(f"{run.HERE}/drivers/fit_video.py",
                           "t_driver_fit_video")


def test_sound_run_is_correct():
    out = run.run_cell(CELL, 2 ** 31 + 5, 0.5, False, device="cpu",
                       overrides=small())
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "step_gap",
                                  "lists_diff"}
    assert set(out["metrics"]) == {"fit_ms_per_sweep", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["frozen", "half"])
def test_planted_fault_is_not_correct(fault):
    out = run.run_cell(CELL, 17, 0.3, False, device="cpu",
                       overrides=small(faults={fault: 1}))
    assert not out["correct"], out["checks"]


def test_control_is_not_correct():
    checks = driver().control_checks(CELL, 23, "cpu", small(), seconds=0.3)
    limits = run.read_json(run.HERE, "limits", CELL + ".json")
    assert any(v > limits[k] for k, v in checks.items()), checks


def test_traced_run_reports_layers_only_where_it_measured():
    """On the CPU the profiler sees no device: the device and span readers
    return nothing, never 0; the host's phase timer is read."""
    out = run.run_cell(CELL, 31, 0.3, True, device="cpu",
                       overrides=small())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"fit.loop_share",
                                   "fit.chunk_ms_per_sweep"}
    assert "breakdown" in out and out["device"]["busy_s"] == 0.0


def reseed_reader():
    return run.load_module(f"{run.HERE}/metrics/video.reseed_ms.py",
                           "r_video_reseed_ms").read


def ms(a, b):
    return a * 1e-3, b * 1e-3


DEVICE = [("gate_expert_fwd_kernel", *ms(1, 3)),
          ("Memcpy DtoH (Device -> Pageable)", *ms(3, 4)),
          ("bwd_pixel_kernel", *ms(12, 14))]


def reseed_host(spans=True):
    host = [("smoe.fit.ls_refresh", *ms(10, 15)),
            ("smoe.fit.eval", *ms(0.5, 4)),
            ("smoe.fit.update_kernel_list", *ms(5, 6))]
    if spans:
        host += [("smoe.fit.reseed", *ms(0, 7.5)),
                 ("smoe.fit.reseed", *ms(20, 21.25))]
    return host


@pytest.mark.parametrize("m", [
    {"reseed_slice": tr.Slice(DEVICE, reseed_host(False), 0.03)},
    {"reseed_slice": tr.Slice([], reseed_host(), 0.03)},
    {"reseed_slice": None}, {}],
    ids=["parent_spans", "no_device", "untraced", "no_slice"])
def test_reseed_reader_reads_nothing_without_its_span(m):
    """As at a program whose reseed opens no such span, on the CPU (no
    device activity), and untraced."""
    assert reseed_reader()(m) is None


def test_reseed_reader_sums_its_spans():
    m = {"reseed_slice": tr.Slice(DEVICE, reseed_host(), 0.03)}
    assert reseed_reader()(m) == pytest.approx(7.5 + 1.25)


def test_seed_zero_is_build_videos_clip(tmp_path):
    """The frozen clip at seed 0 is apps/content.py's, and the volume the
    cell fits is what cli.fit reads from the recipe's .npz of it."""
    from smoe_tpu_torch.apps import content
    from smoe_tpu_torch.io.images import read_image
    vid, affines = content.build_video(h=48, w=64, t=4, shift=2.0,
                                       moving_obj=False)
    mine, aff = video_content.cif_clip(48, 64, 4, 2.0, False, 0)
    assert np.array_equal(vid, mine) and np.array_equal(affines, aff)
    path = os.path.join(tmp_path, "clip.npz")
    np.savez(path, imgs=np.moveaxis((vid * 255).astype(np.uint8), 2, 0),
             affines=affines)
    orig, precision, _ = read_image(path, True)
    assert precision == 8
    assert np.array_equal(orig, video_content.as_fit_reads_it(mine))
    other, _ = video_content.cif_clip(48, 64, 4, 2.0, False, 2 ** 31 + 3)
    assert not np.array_equal(other, mine)
