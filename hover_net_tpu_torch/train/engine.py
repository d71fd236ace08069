"""Event-driven training engine (run_utils/engine.py parity).

The port's copy of hover_net_tpu/train/engine.py (same names, same
behaviour). The engine iterates a dataloader, calls a run_step (the
manager's wrapper of the PyTorch train or eval step), fires events,
and lets callbacks read/write shared State. Engine chaining (validation engine triggered
from the train engine's EPOCH_COMPLETED with shared state) works as in
the reference (run_utils/callbacks/base.py:61-71).
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional

import tqdm


class Events(enum.Enum):
    STARTED = "started"
    EPOCH_STARTED = "epoch_started"
    STEP_STARTED = "step_started"
    STEP_COMPLETED = "step_completed"
    EPOCH_COMPLETED = "epoch_completed"
    COMPLETED = "completed"
    EXCEPTION_RAISED = "exception_raised"


class State:
    """Mutable blackboard shared between engine and callbacks."""

    def __init__(self):
        self.logging = False
        self.log_dir = None
        self.log_info = {}

        self.curr_epoch_step = 0
        self.curr_global_step = 0
        self.curr_epoch = 0

        self.tracked_step_output = {"scalar": {}, "image": {}}
        self.epoch_accumulated_output = {}
        self.step_output = None

        self.run_info = None  # manager-owned training objects
        self.global_state = None  # pointer to the triggering engine's state

    def reset_epoch(self):
        self.tracked_step_output = {"scalar": {}, "image": {}}
        self.epoch_accumulated_output = {}
        self.step_output = None


class RunEngine:
    def __init__(self, engine_name: str, dataloader, run_step: Callable,
                 run_info=None, log_info: Optional[dict] = None,
                 progress: bool = True):
        self.engine_name = engine_name
        # the progress bar; off on the ranks other than 0 of a
        # multi-device run
        self.progress = progress
        self.dataloader = dataloader
        self.run_step = run_step
        self.state = State()
        self.state.run_info = run_info
        self.state.log_info = log_info or {}
        self.handlers: Dict[Events, List] = {e: [] for e in Events}

    def add_event_handler(self, event: Events, callback):
        self.handlers[event].append(callback)

    def _fire(self, event: Events):
        for cb in self.handlers[event]:
            cb.run(self.state, event)

    def run(self, nr_epoch: int = 1, shared_state: Optional[State] = None,
            chained: bool = False):
        if chained:
            self.state.curr_epoch = 0
        self.state.global_state = shared_state

        self._fire(Events.STARTED)
        for _ in range(nr_epoch):
            self.state.curr_epoch_step = 0
            self.state.reset_epoch()
            self._fire(Events.EPOCH_STARTED)

            pbar_kwargs = dict(
                desc=f"{self.engine_name}-{self.state.curr_epoch + 1:03d}",
                leave=True, ncols=100, ascii=True, position=0,
                disable=not self.progress,
            )
            try:
                pbar_kwargs["total"] = len(self.dataloader)
            except TypeError:
                pass
            pbar = tqdm.tqdm(**pbar_kwargs)

            for batch in self.dataloader:
                self._fire(Events.STEP_STARTED)
                self.state.step_output = self.run_step(batch, self.state)
                self._fire(Events.STEP_COMPLETED)
                self.state.curr_epoch_step += 1
                self.state.curr_global_step += 1

                scalars = self.state.tracked_step_output["scalar"]
                if scalars:
                    first = next(iter(scalars.items()))
                    pbar.set_postfix_str(f"{first[0]}={_fmt(first[1])}")
                pbar.update()
            pbar.close()

            self.state.curr_epoch += 1
            self._fire(Events.EPOCH_COMPLETED)
        self._fire(Events.COMPLETED)
        return self.state


def _fmt(v):
    try:
        return f"{float(v):.4f}"
    except (TypeError, ValueError):
        return str(v)
