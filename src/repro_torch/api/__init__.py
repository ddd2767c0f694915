"""Unified tSPM+ session API (PyTorch port) — one façade over the engines.

  * :class:`MiningConfig` — every knob in one frozen dataclass (codec,
    duration fusing, screen mode, backend, memory budget, ...);
  * :class:`MiningSession` — ``fit(dbmart)`` for batch input on a device
    (the card by default), ``submit(key, dates, phenx)`` / ``tick()`` /
    ``run()`` for incremental input (the stream engine), ``metrics()`` /
    ``trace()`` with ``telemetry=True``, and ``plan()`` to inspect the
    engine the planner picked;
  * :class:`SequenceFrame` — the unified result: flat (seq, dur, patient)
    arrays in a canonical order with chainable, lazily-composed mask
    methods (``.screen``, ``.starts_with``, ``.transitive_ends_with``,
    ``.top_k``, ``.to_features``, ``.decode``, ...).

For a fixed cohort the frame's arrays are byte-identical to the reference
package's ``MiningSession.fit`` (tests/test_torch_session.py).
"""
from repro_torch.api.config import ENGINES, MiningConfig, Plan  # noqa: F401
from repro_torch.api.frame import Decoded, Result, SequenceFrame  # noqa: F401
from repro_torch.api.session import MiningSession  # noqa: F401
