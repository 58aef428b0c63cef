"""Device idle in a batch's host work, in % of the traced stretch: the idle
gaps inside the program's ``serving.assemble`` (padding and the
host-to-device copy) and ``serving.results`` spans (the reply dicts, and
the group's futures set).

Read from the port's span recorder over the device trace's idle gaps
(``benchmark/lib/program_spans.py``); None where there is nothing to read."""

from benchmark.lib.program_spans import idle_inside


def read(ctx):
    return idle_inside(ctx, ("serving.assemble", "serving.results"))
