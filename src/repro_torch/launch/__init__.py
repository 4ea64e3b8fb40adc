"""Launchers: the trainer (``train``), the batched server (``serve``) and
the analytic cost model (``analytic``); the dry run and the mesh are not
ported yet (ROADMAP Queue 1 item 12)."""
