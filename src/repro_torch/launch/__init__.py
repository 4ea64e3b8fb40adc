"""Launchers: the batched server (``serve``) and the analytic cost model
(``analytic``); the trainer, the dry run and the mesh are not ported yet."""
