"""Device idle while a request was in the server, in % of the traced stretch:
the idle gaps inside the union of the program's ``serving.request`` spans
(a handler thread's, from the POST to its reply written).

Read from the port's span recorder over the device trace's idle gaps
(``benchmark/lib/program_spans.py``); None where there is nothing to read."""

from benchmark.lib.program_spans import idle_inside


def read(ctx):
    return idle_inside(ctx, ("serving.request",))
