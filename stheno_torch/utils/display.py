"""Multi-line key-value rendering for distribution and model objects.

Counterpart of ``stheno_tpu/utils/display.py``: ``Normal`` and ``FDD``
print as indented key-value blocks, each component on its own line, with
the continuation lines of a nested value aligned under its key."""

__all__ = ["indented_kv"]


def indented_kv(key, value, *, suffix="", indent=4):
    """Render ``key=value`` indented by ``indent`` spaces, with any
    continuation lines of ``value`` aligned one level deeper, followed by
    ``suffix``."""
    pad = " " * indent
    lines = str(value).split("\n")
    out = [f"{pad}{key}={lines[0]}"]
    out.extend(pad + " " * (len(str(key)) + 1) + line for line in lines[1:])
    return "\n".join(out) + suffix
