"""Uncertainty tier: intervals as a served product.

The port of the JAX package's ladder, cheap to gold:

* **MAP predictive** — simulated future changepoints + observation noise
  around the MAP point (``models/prophet/predict.py``; the quantile
  plane's ``"map"`` mode);
* **ADVI** (:mod:`~tsspark_tpu_torch.uncertainty.advi`) — a mean-field
  Gaussian posterior per series, fitted in lockstep over the MAP solve's
  padded tensors: K3's gradient on the (K B, P) draw stack and K7's ELBO
  reduction and Adam step on the card.  The default served tier;
* **HMC gold** (:mod:`~tsspark_tpu_torch.uncertainty.gold`) — full chains
  (``ops/hmc.py``) on a deterministic sampled subset per version,
  auditing the ADVI posterior.

Served through the **quantile plane**
(:mod:`~tsspark_tpu_torch.uncertainty.qplane`, read by
``PredictionEngine.quantiles``) and gated by the **calibration eval**
(:mod:`~tsspark_tpu_torch.uncertainty.calibrate`): empirical coverage vs
nominal per horizon bucket.
"""

from tsspark_tpu_torch.uncertainty.advi import (  # noqa: F401
    AdviPosterior,
    fit_advi,
    load_posterior,
    save_posterior,
)
from tsspark_tpu_torch.uncertainty import calibrate  # noqa: F401
from tsspark_tpu_torch.uncertainty import gold  # noqa: F401
from tsspark_tpu_torch.uncertainty import qplane  # noqa: F401

__all__ = [
    "AdviPosterior",
    "fit_advi",
    "load_posterior",
    "save_posterior",
    "calibrate",
    "gold",
    "qplane",
]
