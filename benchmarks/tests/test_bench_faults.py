"""``correct`` on the CPU at a tiny size, with each cell's own limits: true
for the program as it is, false for the control (the reference in the next
lower operand precision in the program's place) and false with a fault
planted under the timed path: the state left unchanged, half of the work
left out, an answer altered where it is produced. Each cell plants the
faults that ``limits/<cell>.json`` says it catches at its own size (the
readings there are the card's, at the cell's size); a fault that the cell
cannot see at its size is named there and not claimed here. (One chip: no
exchange between chips to leave out.)"""

import harness
import pytest
import torch

from zero_tig_torch.pipeline import steps

TINY = {"frame_height": 64, "frame_width": 96, "of_scale": 2, "raft_iters": 2}
CONTROL = {"highest": "tf32", "fast": "fp8"}
STREAM = [w["name"] for w in harness.spec()["workloads"] if harness.find_cell(w["name"])["traffic"]["driver"] == "stream"]
TRAIN = [w["name"] for w in harness.spec()["workloads"] if harness.find_cell(w["name"])["traffic"]["driver"] == "train"]


def run_cell(cell: str, **options):
    found = harness.find_cell(cell)
    cfg = dict(found["config"], **TINY)
    tr = dict(found["traffic"])
    if tr["driver"] == "stream":
        tr.update(scene_frames=8, sample_chunks=4)
        units = 4
    else:
        tr.update(scene_frames=3, epochs=2, check_steps=4, change_steps=2, trace_from=1, trace_steps=2)
        units = 2
    driver = harness.load_module(found["driver"], "bench_driver_" + tr["driver"])
    return driver.run(harness.Run(cell=cell, config=cfg, traffic=tr, limits=found["limits"], seed=2**31 + 11,
                                  seconds=0.0, device="cpu", min_units=units, options=options))


@pytest.mark.parametrize("cell", STREAM + TRAIN)
def test_sound_run_is_correct_and_control_is_not(cell):
    precision = harness.find_cell(cell)["config"]["precision"]
    out = run_cell(cell, controls=[CONTROL[precision]])
    assert out["correct"], out["checks"]
    control = out["controls"][CONTROL[precision]]
    ok, checks = __import__("check").verdict(control, harness.find_cell(cell)["limits"])
    assert not ok, checks


def _stale_carry(real):
    def chunk(model, frames, carry, flags, **kw):
        outs, _ = real(model, frames, carry, flags, **kw)
        return outs, carry
    return chunk


def _half_chunk(real):
    def chunk(model, frames, carry, flags, **kw):
        (h2, h3), carry = real(model, frames, carry, flags, **kw)
        n = h2.shape[0] // 2
        return (torch.cat([h2[:n], h2[:n]]), torch.cat([h3[:n], h3[:n]])), carry
    return chunk


def _altered(real):
    def chunk(model, frames, carry, flags, **kw):
        (h2, h3), carry = real(model, frames, carry, flags, **kw)
        h3 = h3.clone()
        h3[-1, 0, 0, 0, 0] ^= 0x80
        return (h2, h3), carry
    return chunk


def caught(cells: list[str], faults: dict) -> list[tuple]:
    """(cell, fault) for every fault the cell's limits file claims."""
    out = []
    for cell in cells:
        claimed = harness.read_json(harness.BENCH / "limits" / f"{cell}.json")["faults"]
        assert set(claimed) <= set(faults), claimed
        out += [pytest.param(cell, faults[f], id=f"{cell}-{f}") for f in claimed]
    return out


STREAM_FAULTS = {"stale_carry": _stale_carry, "half_chunk": _half_chunk, "altered": _altered}


@pytest.mark.parametrize("cell, fault", caught(STREAM, STREAM_FAULTS))
def test_stream_fault_is_caught(cell, fault, monkeypatch):
    monkeypatch.setattr(steps, "predict_chunk", fault(steps.predict_chunk))
    assert not run_cell(cell)["correct"]


def _no_update(monkeypatch):
    def step(self):
        for p in self.params:
            p.grad = None
    monkeypatch.setattr(steps.Adam, "step", step)


def _frozen_stats(monkeypatch):
    from zero_tig_torch.models import layers
    monkeypatch.setattr(layers, "move_running_stats", lambda *a, **kw: None)


def _half_rows(monkeypatch):
    real = steps.zero_tig_loss

    def loss(frame, o, **kw):
        return real(frame[:, :frame.shape[1] // 2], type(o)(*[v[:, :v.shape[1] // 2] for v in o]), **kw)
    monkeypatch.setattr(steps, "zero_tig_loss", loss)


def _altered_loss(monkeypatch):
    real = steps.train_step

    def train_step(*a, **kw):
        state, loss = real(*a, **kw)
        return state, loss * 1.1
    monkeypatch.setattr(steps, "train_step", train_step)


TRAIN_FAULTS = {"no_update": _no_update, "frozen_stats": _frozen_stats, "half_rows": _half_rows,
                "altered_loss": _altered_loss}


@pytest.mark.parametrize("cell, fault", caught(TRAIN, TRAIN_FAULTS))
def test_train_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert not run_cell(cell)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", STREAM + TRAIN)
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    import subprocess
    import sys
    import json
    out = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", cell, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"], capture_output=True, text=True, timeout=600,
                         cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
