"""Observability of the port: trace context (``obs.context``), metrics
(``obs.metrics``), the run ledger (``obs.ledger``), the run history and
its regression sentinel (``obs.history``, ``obs.regress``) and the live
SLO watch (``obs.watch``); ``python -m tsspark_tpu_torch.obs`` renders
them."""

from tsspark_tpu_torch.obs.ledger import (  # noqa: F401
    build_ledger,
    derive_mttr,
    write_ledger,
)
