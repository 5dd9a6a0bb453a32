"""Source-level guard: no device-array literals in package code (CLAUDE.md).

A `jnp.array([...])` literal at module level or inside a traced function
becomes a DEVICE-resident constant in the jaxpr; lowering must then fetch
its value back from the device, and that fetch waits behind whatever the
device queue holds. Host `np.array` constants lower instantly and are
otherwise interchangeable in jnp expressions, so the rule is simply: never
write `jnp.array([`/`jnp.asarray([` literals in package code.
"""

import os
import re

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rgbd360_tpu")

_LITERAL = re.compile(r"jnp\.(array|asarray)\(\s*\[")


def test_no_jnp_array_literals_in_package():
    offenders = []
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                for lineno, line in enumerate(f, 1):
                    if _LITERAL.search(line):
                        offenders.append(f"{path}:{lineno}: {line.strip()}")
    assert not offenders, (
        "jnp.array literal(s) found — use np.array (host constants; a "
        "device constant makes lowering wait on a device fetch):\n"
        + "\n".join(offenders)
    )
