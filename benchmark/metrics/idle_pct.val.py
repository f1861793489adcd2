"""The share of the traced window in which no operation ran on the card."""

import readers


def read(info):
    return readers.idle_pct(info)
