"""The benchmark of ``comapreduce_tpu_torch`` on one NVIDIA H100.

``run.py`` is the entry; everything a cell needs is found by name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py``, ``metrics/<metric>.py``. See ``README.md``.
"""
