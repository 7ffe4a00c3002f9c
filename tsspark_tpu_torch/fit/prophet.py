"""``tsspark_tpu_torch.fit.prophet`` — migration alias for the reference's
``tsspark.fit.prophet`` module (the piecewise-linear-trend + Fourier-
seasonality design-matrix build and the L-BFGS MAP inner loop), with the
JAX package's ``fit.prophet`` names, each the port's object.  A user's
imports keep working with the package rename; the canonical homes are
``tsspark_tpu_torch.models.prophet.*`` and ``tsspark_tpu_torch.config``."""

from tsspark_tpu_torch.config import (  # noqa: F401
    DAILY,
    McmcConfig,
    ProphetConfig,
    RegressorConfig,
    SeasonalityConfig,
    SolverConfig,
    WEEKLY,
    YEARLY,
)
from tsspark_tpu_torch.models.prophet.design import (  # noqa: F401
    FitData,
    ScalingMeta,
    prepare_fit_data,
    quantile_changepoints,
)
from tsspark_tpu_torch.models.prophet.init import (  # noqa: F401
    curvature_diag,
    initial_theta,
    ridge_init,
)
from tsspark_tpu_torch.models.prophet.loss import (  # noqa: F401
    neg_log_posterior,
    value_and_grad_batch,
    value_batch,
)
from tsspark_tpu_torch.models.prophet.model import (  # noqa: F401
    FitState,
    McmcState,
    ProphetModel,
    fit_core,
)
from tsspark_tpu_torch.models.prophet.predict import (  # noqa: F401
    forecast,
    prepare_predict_data,
)
from tsspark_tpu_torch.models.prophet.seasonality import (  # noqa: F401
    auto_seasonalities,
    fourier_features,
    seasonal_feature_matrix,
)
