"""Serving front door (DESIGN.md §14): the live asyncio gateway over
the planned fleet, its stdlib HTTP server, and the open/closed-loop
load-generator client.

A copy of the JAX package's ``gateway/__init__.py``."""
from repro_torch.gateway.core import (AdmissionRejected, AsyncGateway,
                                      GatewayRequest)
from repro_torch.gateway.loadgen import (LoadReport, closed_loop,
                                         direct_submitter, http_submitter,
                                         open_loop)
from repro_torch.gateway.server import GatewayHTTPServer, build_demo_gateway

__all__ = ["AdmissionRejected", "AsyncGateway", "GatewayHTTPServer",
           "GatewayRequest", "LoadReport", "build_demo_gateway",
           "closed_loop", "direct_submitter", "http_submitter",
           "open_loop"]
