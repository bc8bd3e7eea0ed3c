"""slots_live.serve: the share of the engine's slots that hold a live
request (its `active` gauge over `slots`), the mean of the readings taken
evenly over the window, in %: how much of the batch the traffic and the
admission flags keep filled."""


def read(rec):
    if not rec.load:
        return None
    return 100.0 * sum(x["active"] / x["slots"] for x in rec.load) / len(rec.load)
