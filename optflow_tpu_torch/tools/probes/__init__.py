"""The repository's solver probes (``tools/probes/``) as the port's entry
points on the card, each run as ``python -m
optflow_tpu_torch.tools.probes.<name>``:

  r4_budget          the headline solve's time budget: reference defaults,
                     epsilon 0, one iteration, one warp, the pyramid alone,
                     and the cost of a launch (``r4_budget.py``,
                     ``r4_warp_vs_iter.py``, ``r4_where_time.py``,
                     ``r4_dispatch_cost.py``)
  r4_feature_stages  pre-alignment by stage, and the solve it feeds
  r5_sample_stage    a job's device group by piece
  r5_transfer_cost   host<->device copies at the job's shapes

Each prints one JSON line with the card's name and power limit, runs on
``--device cuda`` unless the caller passes ``--device cpu`` (``--quick`` for
a check on the CPU), times each row from an idle card (CUDA events for the
card's time: ``bench.timed``), and exits non-zero where its gate fails. The
probes' TPU-only rows are left out, each module says which. The full-section
probes are a bench: ``python -m optflow_tpu_torch.bench.section``.
"""
