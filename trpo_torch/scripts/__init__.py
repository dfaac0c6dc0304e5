"""The port's command-line tools over event logs and replay bundles
(counterparts: the reference's ``scripts/`` of the same names). Each runs
as ``python -m trpo_torch.scripts.<name>``:

* ``analyze_run`` — summarize one run, compare two (exit 0/1/2), merge
  per-process logs, show a trace's waterfall, export a replay bundle;
* ``replay_run`` — re-execute a bundle against a shadow replica set;
* ``validate_events`` — schema and cross-record contracts of event logs;
* ``observatory`` — a live or offline dashboard with the default alerts;
* ``seed_corpus`` — record, mine or regenerate replay material.
"""
