"""Milliseconds a request of the Clipper facade's own work, outside the
PGA loop and the rounding: the self time of the program's spans
``facade.score`` and ``facade.solve`` (input conversion, association,
endpoints, the build's launch, the generator's set-up, the mask's copy to
the host) over the traced window's requests."""

from benchmark import program_trace


def read(record):
    return program_trace.per_request(
        record, lambda spans, counters: (
            spans["facade.score"]["self_ms"]
            + spans["facade.solve"]["self_ms"]))
