"""Drivers of the traffic mixes, one module a mix ``kind``."""
