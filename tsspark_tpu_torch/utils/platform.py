"""Platform helpers (the port's copy of the JAX package's
``utils/platform.py``).

* ``honor_env_platforms``: the device an entry point runs on when the
  environment names one (``$TSSPARK_DEVICE``: ``cpu``, ``cuda``,
  ``cuda:1``); unset, the card, as every entry point of the port
  defaults (``device.resolve_device``: no card and no request raises).
  The worker processes (``python -m tsspark_tpu_torch.orchestrate``) and
  the eval CLIs (``eval.configs``, ``eval.parity``) read it when no
  ``--device`` is given, where the reference's read ``JAX_PLATFORMS``.
* ``host_cpu_tag``: a host-CPU fingerprint for caches keyed on the
  machine's features.

The reference's ``enable_persistent_compile_cache`` has no counterpart
here: the kernels are compiled once by ``nvcc`` into
``kernels.build.build_dir()``, which already outlives the process (the
library's name carries the sources' digest, so every later process loads
that build).
"""

from __future__ import annotations

import os

#: The environment variable naming the device of an entry point.
DEVICE_ENV = "TSSPARK_DEVICE"


def honor_env_platforms(default=None):
    """The ``torch.device`` named by ``$TSSPARK_DEVICE``, else
    ``default`` (``None``: the card), resolved as every entry point
    resolves its device."""
    from tsspark_tpu_torch.device import resolve_device

    return resolve_device(os.environ.get(DEVICE_ENV) or default)


def host_cpu_tag() -> str:
    """Host-CPU fingerprint: a hash of the cpuinfo flags line (x86
    "flags", ARM64 "Features"), so caches keyed on it are never reused
    on a machine with other CPU features."""
    import hashlib

    try:
        with open("/proc/cpuinfo") as fh:
            line = next(
                ln for ln in fh
                if ln.startswith("flags") or ln.startswith("Features")
            )
    except (OSError, StopIteration):
        import platform as _platform

        line = _platform.platform()
    return hashlib.md5(line.encode()).hexdigest()[:8]
