"""Mixtral: the Mistral family with its experts (`num_local_experts`)."""

from portbench.families.mistral import *  # noqa: F401,F403
