"""The port's probes (``optflow_tpu_torch/tools/probes/``) on the CPU: the
budget's solve rows against the JAX package's solver under the same
replacement of its parameters, and each probe's gate, which passes on the
probe's own calls and fails where one of its pieces is made to differ.
Their lines' keys are in ``tests/test_torch_bench.py``'s keys test."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optflow_tpu.core.config import TVL1Params as JaxParams
from optflow_tpu.ops import tvl1 as jtv
from optflow_tpu_torch import convert
from optflow_tpu_torch.bench import solve
from optflow_tpu_torch.ops import tvl1 as ttv
from optflow_tpu_torch.tools.probes import (
    r4_budget,
    r4_feature_stages,
    r5_sample_stage,
    r5_transfer_cost,
)
from tests.test_torch_bench import jax_level_counts

# tiny tensors: a thread pool only adds fork-join waits, which a loaded
# machine turns into scheduler quanta
torch.set_num_threads(1)

QUICK = ["--device", "cpu", "--quick"]


@pytest.mark.parametrize("row", list(r4_budget.SOLVE_ROWS))
def test_budget_rows_equal_the_jax_packages_solver(row):
    """Each solve row of ``r4_budget`` at its ``--quick`` size, (2, 48, 128)
    at 3 scales, against the JAX package's ``tvl1_flow_batched`` under the
    same replacement of the parameters: within 1e-4 px, and every level's
    count of every image equal to the jnp loop's; without an exit
    (``full_eps0``) that is warps x iterations at every level."""
    i0, i1 = solve.solve_inputs(2, 48, 128)
    jp = dataclasses.replace(JaxParams(nscales=3),
                             **r4_budget.SOLVE_ROWS[row])
    base = convert.params_from_reference(dataclasses.asdict(
        JaxParams(nscales=3)))
    tp = r4_budget.row_params(base, row)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    got = ttv.tvl1_flow_batched(torch.from_numpy(i0), torch.from_numpy(i1),
                                tp).numpy()
    counts = [it.tolist() for _, it in ttv.get_last_iteration_stats()]
    want = np.asarray(jtv.tvl1_flow_batched(jnp.asarray(i0),
                                            jnp.asarray(i1), jp))
    assert np.abs(got - want).max() <= 1e-4
    if tp.epsilon == 0.0:
        assert counts == [[tp.warps * tp.iterations] * 2] * 3
    else:
        assert counts == jax_level_counts(i0, i1, jp)


def _gate(capsys, main):
    """``main(QUICK)``: its line, or the message it exited with."""
    try:
        main(QUICK)
    except SystemExit as e:
        return json.loads(capsys.readouterr().out.splitlines()[-1]), e.code
    return json.loads(capsys.readouterr().out.splitlines()[-1]), None


@pytest.mark.parametrize("differ", [False, True])
def test_the_feature_stages_compose_the_prealign(differ, capsys,
                                                 monkeypatch):
    """The stages' affine equals the prealign's at 0.0 px; a stage whose
    matched points lie half a pixel off fails the gate."""
    if differ:
        points = r4_feature_stages.matched_points

        def shifted(*a):
            p0, p1 = points(*a)
            return p0, p1 + 0.5

        monkeypatch.setattr(r4_feature_stages, "matched_points", shifted)
    rec, exited = _gate(capsys, r4_feature_stages.main)
    assert rec["composed_gate_px"] == r4_feature_stages.COMPOSED_GATE_PX
    if differ:
        assert not rec["gate_ok"] and "composed" in exited
        assert rec["composed_vs_prealign_corner_px"] > 0.0
    else:
        assert rec["gate_ok"] and exited is None
        assert rec["composed_vs_prealign_corner_px"] == 0.0


@pytest.mark.parametrize("differ", [False, True])
def test_the_group_pieces_give_the_whole_calls_samples(differ, capsys,
                                                       monkeypatch):
    """The device group's pieces give ``solve_group_on_device``'s packed
    samples bit for bit; a sampler drawing from another seed fails the
    gate."""
    if differ:
        monkeypatch.setattr(r5_sample_stage, "SEED", 1)
        whole = r5_sample_stage.solve_group_on_device
        monkeypatch.setattr(r5_sample_stage, "solve_group_on_device",
                            lambda *a, seed, **k: whole(*a, seed=0, **k))
    rec, exited = _gate(capsys, r5_sample_stage.main)
    assert rec["pieces_equal_whole"] is (not differ)
    assert (exited is None) is (not differ)
    assert rec["rows"]["solve"]["px_iterations"] > 0


@pytest.mark.parametrize("differ", [False, True])
def test_every_copy_is_read_back_equal(differ, capsys, monkeypatch):
    """Every copy reads back equal to its source; copies whose first
    element comes back changed fail the gate."""
    if differ:
        timed = r5_transfer_cost.timed

        def changed(dev, fn, reps):
            out, t = timed(dev, fn, reps)
            out = out.clone()
            out.view(-1)[0] += 1
            return out, t

        monkeypatch.setattr(r5_transfer_cost, "timed", changed)
    rec, exited = _gate(capsys, r5_transfer_cost.main)
    assert rec["readback_equal"] is (not differ)
    assert (exited is None) is (not differ)
