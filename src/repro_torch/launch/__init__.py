"""Launchers: the trainer (``train``, ``--mesh`` included), the batched
server (``serve``), the analytic cost model (``analytic``), the meshes
(``mesh``) and the dry run (``dryrun``)."""
