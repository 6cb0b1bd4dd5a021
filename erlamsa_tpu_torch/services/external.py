"""External extension modules: the -e hook (erlamsa_tpu/services/
external.py).

Reference: erlamsa loads compiled beams declaring ``capabilities()`` in
{mutations, post, generator, fuzzer, monitor, logger, pattern}
(erlamsa_cmdparse:parse_external, src/erlamsa_cmdparse.erl:456-470;
examples external_muta.erl / external_nhrp.erl). Here an external module is
any importable Python module with the same contract:

    def capabilities() -> set[str]            # which hooks it provides
    def mutations() -> list[tuple]            # [(score, pri, fn, name)]
        where fn(ctx, ll, meta) -> (fn', ll', meta', delta)
    def generator() -> (blocks, meta)         # genfuz source
    def grammar() -> genfuzz grammar          # alternative genfuz source
    def post(data: bytes) -> bytes            # output post-processor
    def fuzzer(proto, data, session) -> bytes # gfcomms/proxy fuzzer

The oracle engine (oracle/engine.py) appends ``custom_mutations`` to its
mutator table and runs ``post`` over every output; the proxy's oracle
escape and the bridge's FUZZ_CASE reach it through the same opts.
"""

from __future__ import annotations

import importlib

from ..constants import MAX_SCORE


class ExternalModule:
    def __init__(self, module_name: str):
        self.mod = importlib.import_module(module_name)
        caps = getattr(self.mod, "capabilities", lambda: set())()
        self.capabilities = set(caps)

    def custom_mutations(self, ctx) -> list[list]:
        """Rows appended to the oracle registry
        (make_mutator's CustomMutas, src/erlamsa_mutations.erl:1370-1383)."""
        if "mutations" not in self.capabilities:
            return []
        rows = []
        for entry in self.mod.mutations():
            if len(entry) == 4:
                score, pri, fn, name = entry
            else:
                score, pri, fn, name, _desc = entry
            rows.append([score or MAX_SCORE, pri,
                         self._wrap_mutation(ctx, fn), name])
        return rows

    def _wrap_mutation(self, ctx, fn):
        """Adapt (ctx, ll, meta) -> ... to the mux's (ll, meta) protocol.
        The continuation returned to the mux is always the wrapper (wrapping
        whatever continuation the module returned), never the raw fn."""

        def make(cur):
            def wrapped(ll, meta):
                res = cur(ctx, ll, meta)
                if len(res) == 4:
                    nfn, nll, nmeta, delta = res
                else:
                    nfn, nll, nmeta = res
                    delta = 1
                cont = wrapped if nfn is cur else make(nfn)
                return cont, nll, nmeta, delta

            return wrapped

        return make(fn)

    def generator(self):
        """The module's genfuz source, or None: its ``generator``, or a
        generator over the grammar its ``grammar()`` returns
        (models/genfuzz.make_external_generator)."""
        if "generator" in self.capabilities and hasattr(self.mod, "generator"):
            return self.mod.generator
        if hasattr(self.mod, "grammar"):
            from ..models.genfuzz import make_external_generator

            return make_external_generator(self.mod.grammar())
        return None

    def post(self):
        if "post" in self.capabilities:
            return self.mod.post
        return None

    def fuzzer(self):
        if "fuzzer" in self.capabilities:
            return self.mod.fuzzer
        return None


def load_external(module_name: str | None) -> ExternalModule | None:
    if not module_name:
        return None
    return ExternalModule(module_name)
