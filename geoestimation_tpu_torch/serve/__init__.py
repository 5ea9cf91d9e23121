"""Serving: the dynamic-batching inference server of the port."""

from .server import GeoInferenceServer, MicroBatcher

__all__ = ["GeoInferenceServer", "MicroBatcher"]
