"""Logging of the port.

Copy of ``gpu_olap_tpu/utils/tracing.py``, trimmed to what the port calls:
stdlib loggers named after their module.
"""

from __future__ import annotations

import logging


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
