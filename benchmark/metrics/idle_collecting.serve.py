"""Device idle while the dispatcher collected a group, in % of the traced
stretch: the idle gaps inside the program's ``serving.collect`` spans
(from a group's first request taken off the queue to the group's close).

Read from the port's span recorder over the device trace's idle gaps
(``benchmark/lib/program_spans.py``); None where there is nothing to read."""

from benchmark.lib.program_spans import idle_inside


def read(ctx):
    return idle_inside(ctx, ("serving.collect",))
