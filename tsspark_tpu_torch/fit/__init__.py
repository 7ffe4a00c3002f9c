"""Compatibility namespace mirroring the reference's ``tsspark.fit``
package path, as the JAX package's ``fit`` package does: everything here
is an alias onto the canonical modules under
``tsspark_tpu_torch.models.prophet``."""

from tsspark_tpu_torch.fit import prophet  # noqa: F401
