"""`correct` at a small size on the CPU: the harness's run with everything
but the look for a card, sound, then with the timed path broken
underneath (each fault a cell can have), and the control (the TF32
reference in the program's place).  Each cell's limits are its own, as
the card's runs use them."""

import pytest

import control
import run

FIT_FAULTS = ("frozen", "half")
DECODE_FAULTS = ("stale", "altered")
CELLS = ("still512.fit", "still4k.fit", "still4k.decode")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, small):
    out = run.run_cell(cell, 2 ** 31 + 5, 0.5, False, device="cpu",
                       overrides=small[cell])
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell,fault",
                         [(c, f) for c in CELLS[:2] for f in FIT_FAULTS]
                         + [(CELLS[2], f) for f in DECODE_FAULTS])
def test_planted_fault_is_not_correct(cell, fault, small):
    ov = dict(small[cell], faults=control.FAULTS[fault])
    out = run.run_cell(cell, 17, 0.5, False, device="cpu", overrides=ov)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, small):
    checks = control.control_checks(cell, 23, "cpu", small[cell])
    limits = run.read_json(run.HERE, "limits", cell + ".json")
    assert any(v > limits[k] for k, v in checks.items()), checks


def test_traced_run_reports_layers_only_where_it_measured(small):
    """On the CPU the profiler sees no device: the device readers return
    nothing, never 0; the host's spans are read."""
    out = run.run_cell("still512.fit", 31, 0.5, True, device="cpu",
                       overrides=small["still512.fit"])
    assert set(out["metrics"]) == {"fit.loop_share",
                                   "fit.chunk_ms_per_sweep"}
    assert "breakdown" in out and out["device"]["busy_s"] == 0.0


@pytest.mark.parametrize("cell", CELLS[:2])
def test_second_stage_is_compared(cell, small):
    """The stage checked after the window counts: the reference's own
    record passes, and a step altered in that stage alone does not."""
    cfg = dict(run.read_json(run.HERE, "configs",
                             run.find_cell(run.read_json(run.ROOT,
                                                         "BENCHMARK.json"),
                                           cell)["config"] + ".json"),
               **small[cell]["config"])
    mix = dict(run.read_json(run.HERE, "traffic", "fit_ls.json"
                             if cell == "still512.fit" else
                             "fit_plain.json"), **small[cell]["traffic"])
    drv = run.load_module(f"{run.HERE}/drivers/fit.py", "drv_fit_stage")
    from reference import smoe_ref as R
    from yardstick import content
    image = content.build(cfg["content"], 41)
    init = R.grid_init(image, int(cfg["kernels_per_dim"]))
    block = tuple(cfg["block_shape"]) if cfg.get("block_shape") \
        else image.shape[:2]
    ctx = dict(cfg=cfg, traffic=mix, device="cpu")
    limits = run.read_json(run.HERE, "limits", cell + ".json")
    rec = drv.reference_record(ctx, image, block, init, "fp32")
    sound = drv.check(ctx, image, block, init, rec, "fp32")
    assert all(v <= limits[k] for k, v in sound.items()), sound
    end = dict(rec["end"])
    rec["end"] = dict(end, p3={f: end["p0"][f] + 2.0 * (v - end["p0"][f])
                               for f, v in end["p3"].items()})
    broken = drv.check(ctx, image, block, init, rec, "fp32")
    assert broken["step_gap"] > limits["step_gap"], broken
    if "p3_ls" in end:
        # the LS refresh taken at twice the line search's step
        rec["end"] = dict(end, p3_ls={
            f: v + (v - end["p3"][f]) for f, v in end["p3_ls"].items()})
        broken = drv.check(ctx, image, block, init, rec, "fp32")
        assert broken["ls_gap"] > limits["ls_gap"], broken


def test_decode_compares_a_full_sample_of_a_short_window(small, capsys):
    """The sample is drawn from the requests the window finished, so a
    short window compares as many images as a long one."""
    out = run.run_cell("still4k.decode", 2 ** 31 + 19, 0.3, False,
                       device="cpu", overrides=small["still4k.decode"])
    assert out["correct"], out["checks"]
    n_keep = run.read_json(run.HERE, "traffic",
                           "decode_file.json")["sample_requests"]
    look = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("look: compared")]
    # the last request is always compared, and may be in the sample
    assert n_keep <= int(look[-1].split()[2]) <= n_keep + 1
