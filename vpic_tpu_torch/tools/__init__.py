"""The port's counterparts of the repository's ``tools/`` scripts: the
probe kernels of ``tools/probe_batched.py`` and
``tools/vpu_layout_probe.py`` (``csrc/probes.cu``) and the drift comparison
of ``tools/drift_compare.py``, each runnable with ``python -m``."""
