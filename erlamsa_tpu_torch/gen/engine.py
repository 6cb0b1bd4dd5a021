"""GenEngine: the host-side face of grammar generation on the card (a
copy of erlamsa_tpu/gen/engine.py).

Owns one compiled grammar plus its batch expander and turns "give me N
generated samples for case C" into either ONE expander call on the run's
device (the hot path — zero per-sample host work) or, when the device
call fails, a per-(case, slot) walk of the keyed host twin
(models/genfuzz.generate_keyed). Both paths consume the identical
TAG_GEN draw chain, so a campaign that loses its device mid-generation
produces byte-identical panels to one that never did — the same
availability-over-latency trade the corpus runner makes, pinned by
tests. The device call is guarded by the ``gen.expand`` chaos site
(services/chaos.py), which is how the fallback path gets exercised in
tests instead of waiting for a real device fault.

Recovery mirrors corpus/runner.py: after a failure the engine serves
from the host twin and re-probes the device every PROBE_EVERY
expansions, clearing the degraded flag on success.
"""

from __future__ import annotations

import numpy as np

from ..obs import flight
from ..services import metrics
from ..services.chaos import InjectedFault, fault_point
from .compile import CompiledGrammar

PROBE_EVERY = 4  # degraded-mode device re-probe cadence, in expansions
# warm(): the case it expands, past any that a caller uses (gfcomms
# counts connections from 0)
WARM_CASE = 2**31 - 1


class GenEngine:
    def __init__(self, compiled: CompiledGrammar, seed, fuzz: bool = False,
                 device=None):
        self.cg = compiled
        self.seed = seed
        self.fuzz = bool(fuzz)
        self.device = device  # None: the card (resolved at first use)
        self.degraded = False
        self.host_fallbacks = 0
        self.expansions = 0
        self._fn = None
        self._base = None
        self._probe_in = 0

    # -- device path -----------------------------------------------------

    def _ensure_fn(self):
        if self._fn is None:
            from .. import resolve_device
            from ..ops import grammar, prng

            self._base = prng.base_key(self.seed,
                                       device=resolve_device(self.device))
            self._fn = grammar.make_expand(self.cg, fuzz=self.fuzz)
        return self._fn

    def _device_expand(self, case_idx, slots: np.ndarray):
        fn = self._ensure_fn()
        panel, lens, trunc = fn(self._base, case_idx, slots)
        return (
            panel.cpu().numpy(),
            lens.cpu().numpy(),
            trunc.cpu().numpy(),
        )

    def warm(self):
        """Build the expander, move the tables to the device and expand
        one sample of a case no caller uses, counting nothing: the set-up
        a first expansion would otherwise wait on. A device error is left
        for that expansion to meet (and degrade on)."""
        from ..ops.pipeline import is_device_error

        try:
            self._device_expand(WARM_CASE, np.zeros(1, np.int32))
        except Exception as e:  # re-raised unless the device failed
            if not is_device_error(e):
                raise

    # -- host twin -------------------------------------------------------

    def _host_expand(self, case_idx, slots: np.ndarray):
        import torch

        from ..models.genfuzz import generate_keyed
        from ..ops import grammar, prng

        cases = torch.as_tensor(np.asarray(case_idx, np.int64))
        ck = grammar.gen_case_key(prng.base_key(self.seed),
                                  self.cg.grammar_id, cases)
        keys = prng.fold_in(ck.reshape(-1, 2), torch.from_numpy(
            slots.astype(np.int64))).tolist()
        rows, lens, truncs = [], [], []
        for skey in keys:
            row, ln, tr = generate_keyed(self.cg, skey, fuzz=self.fuzz)
            rows.append(np.frombuffer(row, np.uint8))
            lens.append(ln)
            truncs.append(int(tr))
        return (
            np.stack(rows) if rows else np.zeros((0, self.cg.width),
                                                 np.uint8),
            np.asarray(lens, np.int32),
            np.asarray(truncs, np.int32),
        )

    # -- public API ------------------------------------------------------

    def expand(self, case_idx, n: int | None = None, slots=None):
        """Generate one panel: samples for `slots` (or range(n)) of
        `case_idx` (one case, or one case per slot). Returns (payloads
        list[bytes], truncated_count). Device-first; degrades per-(case,
        slot) to the keyed host twin on an injected or real device
        failure."""
        if slots is None:
            slots = np.arange(int(n), dtype=np.int32)
        else:
            slots = np.asarray(slots, np.int32)
        if np.ndim(case_idx):
            case_idx = np.asarray(case_idx, np.int64)
        else:
            case_idx = int(case_idx)
        used_host = False
        if self.degraded:
            self._probe_in -= 1
            probe = self._probe_in <= 0
        else:
            probe = True
        if probe:
            try:
                fault_point("gen.expand")
                panel, lens, trunc = self._device_expand(case_idx, slots)
                if self.degraded:
                    from ..services import logger

                    logger.log("info", "gen: device recovered, leaving "
                               "degraded mode")
                    self.degraded = False
                    metrics.GLOBAL.set_gen_degraded(False)
            except Exception as e:  # re-raised below unless device/injected
                from ..ops.pipeline import is_device_error

                if not isinstance(e, InjectedFault) and not is_device_error(e):
                    raise
                used_host = True
        else:
            used_host = True
        if used_host:
            if not self.degraded:
                from ..services import logger

                logger.log("warning", "gen: device expansion failed, "
                           "degrading to keyed host oracle")
                self.degraded = True
                metrics.GLOBAL.set_gen_degraded(True)
            if probe:
                # only a *failed probe* re-arms the countdown; countdown
                # expansions must keep draining toward the next probe
                self._probe_in = PROBE_EVERY
            panel, lens, trunc = self._host_expand(case_idx, slots)
            self.host_fallbacks += len(slots)
            metrics.GLOBAL.record_gen_fallback(len(slots))

        payloads = [
            panel[i, : int(lens[i])].tobytes() for i in range(len(slots))
        ]
        nbytes = int(lens.sum())
        ntrunc = int(trunc.sum())
        self.expansions += len(slots)
        metrics.GLOBAL.record_gen_expand(len(slots), nbytes, ntrunc)
        flight.GLOBAL.note(
            "gen_panel",
            grammar=self.cg.source,
            grammar_id=self.cg.grammar_id,
            case=(case_idx if isinstance(case_idx, int)
                  else sorted(set(case_idx.tolist()))),
            samples=len(slots),
            bytes=nbytes,
            truncated=ntrunc,
            host=used_host,
        )
        return payloads, ntrunc
