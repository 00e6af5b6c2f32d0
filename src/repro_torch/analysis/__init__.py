"""Static analysis of a fabric before it runs: the pre-flight verifier
(:mod:`repro_torch.analysis.verify`), host code that builds the
channel-dependency graph of the routes, checks it for cycles
(Dally–Seitz) and reports what ``Fabric.verify(spec)`` can prove
without a single engine step."""

from .verify import (ChannelGraph, Finding, VerifyReport,  # noqa: F401
                     channel_graph, describe_channel, verify_fabric)

__all__ = ["ChannelGraph", "Finding", "VerifyReport", "channel_graph",
           "describe_channel", "verify_fabric"]
