"""Serving engines: `engine.ServeEngine`, the LM token server, and
`forecast.ForecastEngine`, the continuous-batching forecast service."""

from repro_torch.serve.forecast import (STATUSES, ForecastEngine,
                                        ForecastRequest, ForecastResult,
                                        QueueFullError, RoundDeadlineError)

__all__ = ["ForecastEngine", "ForecastRequest", "ForecastResult",
           "QueueFullError", "RoundDeadlineError", "STATUSES"]
