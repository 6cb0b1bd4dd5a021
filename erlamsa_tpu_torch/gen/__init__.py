"""Device grammar generation: compiler + engine (erlamsa_tpu/gen).

gen/compile.py flattens genfuzz grammars (models/genfuzz.py tuple form
or the --gen s-expression DSL) into fixed-shape int32/uint8 tables;
ops/grammar.py expands those tables as a bounded, counter-keyed stack
machine on the card, every sample of a panel in lockstep; gen/engine.py
wraps both behind the ``gen.expand`` chaos site with a byte-identical
keyed host twin (models/genfuzz.generate_keyed) as the fallback.
"""

from .compile import (BUILTIN_GRAMMARS, CompiledGrammar, GenSpecError,
                      compile_grammar, load_grammar, parse_grammar)
from .engine import GenEngine

__all__ = [
    "BUILTIN_GRAMMARS",
    "CompiledGrammar",
    "GenSpecError",
    "GenEngine",
    "compile_grammar",
    "load_grammar",
    "parse_grammar",
]
