"""The 95th percentile, over the windows closed in the host phase, of the
receiver's ``cli.window`` span in ms: from the return of the source read
that completed a window to the end of the emit of its messages (the part of
the emit latency after the window's fill and look-ahead)."""

from .. import program_spans
from ..stats import percentile

SPANS = ()
program_spans.install()


def read(data):
    host = getattr(data, "program_host", None)
    if host is None or not host.windows_ms:
        return None
    return percentile(host.windows_ms, 95)
