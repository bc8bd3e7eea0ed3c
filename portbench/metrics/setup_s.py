"""setup_s: process start to the start of the window, in seconds (import,
weights made on the card, the engine or trainer built and warmed, the
warm traffic). The parts are printed on standard error."""


def read(rec):
    return rec.setup_s
