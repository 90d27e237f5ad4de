"""The dealerless key lifecycle — the port's copy of `coconut_tpu/keylife/`:
the online DKG and proactive refresh rounds (dkg.py), the epoch registry
with its bounded live window and two-phase activate / retire handoff
(epoch.py), and the manager that rolls rounds into the registry and every
attached service (manager.py). Host spec arithmetic, as in the reference;
the services it feeds run their crypto on TorchBackend."""

from .dkg import DkgResult, run_dkg, run_refresh
from .epoch import (
    ACTIVE,
    EPOCH_STATE_CODES,
    EPOCH_STATE_OF_CODE,
    PENDING,
    RETIRED,
    RETIRING,
    EpochRegistry,
    KeySet,
)
from .manager import KeyLifecycleManager, aggregate_vk

__all__ = [
    "ACTIVE",
    "DkgResult",
    "EPOCH_STATE_CODES",
    "EPOCH_STATE_OF_CODE",
    "EpochRegistry",
    "KeyLifecycleManager",
    "KeySet",
    "PENDING",
    "RETIRED",
    "RETIRING",
    "aggregate_vk",
    "run_dkg",
    "run_refresh",
]
