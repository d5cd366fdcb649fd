"""The framed driver on a wide plane: `framed.py` with `reference_wide.py`.

Adds nothing of its own. It loads `drivers/framed.py` as a module instance
of its own (the cells of other configurations keep theirs) and sets that
instance's reference to `reference_wide`, whose events keep a pixel index
past 24 bits; `run` is that instance's.
"""

from pathlib import Path

from portbench import harness, reference_wide

_framed = harness.load_module(Path(__file__).resolve().parent / "framed.py")
_framed.reference = reference_wide
run = _framed.run
