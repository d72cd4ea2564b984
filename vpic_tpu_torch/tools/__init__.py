"""The port's counterparts of the repository's ``tools/`` scripts: the
probe kernels of ``tools/probe_batched.py`` and
``tools/vpu_layout_probe.py`` (``csrc/probes.cu``), the drift comparison
of ``tools/drift_compare.py``, and the harness tools ``evidence``,
``scaling_bench`` and ``profile_step``, each runnable with ``python -m``."""
