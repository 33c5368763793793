"""Fit set-up: host seconds of ``prepare_fit`` (flatten, grid and bins
through the native binner, padding, buckets, upload), synchronised."""


def read(obs):
    return obs.prep_s
