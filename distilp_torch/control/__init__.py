"""Closed-loop fleet control: the layer that ACTS on ``/signals``.

The obs layer builds the measurement substrate (timeline, SLO burn rates,
the versioned signals payload, compile/memory ledgers); this package
spends it. ``ControlPolicy`` (declarative JSON: target bands +
hysteresis + cooldown) drives ``Controller.decide`` — a deterministic
function from signal sequence to typed ``Action`` sequence — and
``ControlLoop`` actuates those actions on a dynamic gateway: spawn or
retire process workers (the consistent-hash ring rebalance migrates
shards live, warm, zero cold ticks), flip forced-degrade admission,
adapt ``spec_k``. ``Controller.replay`` reproduces any live decision
trail offline from a dumped timeline — the purity ``make
smoke-autoscale`` pins.
"""

from .controller import ControlLoop, Controller
from .policy import Action, ControlPolicy, actions_to_jsonl

__all__ = [
    "Action",
    "ControlLoop",
    "ControlPolicy",
    "Controller",
    "actions_to_jsonl",
]
