"""Cross-run identity of a report: the git revision it was produced at.

The one helper of the JAX package's ``obs/history.py`` that the port's
reports stamp (``eval/parity.py``).
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, Optional

_git_rev_cache: Dict[str, Optional[str]] = {}


def git_rev(root: Optional[str] = None) -> Optional[str]:
    """Short git revision of ``root`` (default: the checkout this package
    is imported from); None outside a checkout.  Cached per root."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        )))
    key = os.path.abspath(root)
    if key not in _git_rev_cache:
        rev = None
        try:
            out = subprocess.run(
                ["git", "rev-parse", "--short=10", "HEAD"],
                cwd=key, capture_output=True, text=True, timeout=10,
            )
            if out.returncode == 0:
                rev = out.stdout.strip() or None
        except (OSError, subprocess.SubprocessError):
            pass
        _git_rev_cache[key] = rev
    return _git_rev_cache[key]
