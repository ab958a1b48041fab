"""Execution context: device selection and global runtime facts.

The analogue of ``hp_ctx`` / ``dvren::Context`` (reference
``hotpath/src/runtime/hp_runtime.cpp:15-43``, ``src/core/context.cpp:33-56``).
In the reference the context is nearly stateless (flags + preferred device
string); here it additionally pins the JAX device set the renderer compiles
for, which replaces the reference's memspace-based dispatch
(hp_runtime.cpp:171-184): in JAX the placement of the data decides where a
jitted executable runs, and the Context records the intended default.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax

from dvren_tpu.core.status import DvrenError
from dvren_tpu.version import VERSION_MAJOR, VERSION_MINOR, VERSION_PATCH


@dataclass(frozen=True)
class ContextOptions:
    """Mirrors ``hp_ctx_desc`` (hp.h:87-91)."""

    flags: int = 0
    preferred_device: str = ""


class Context:
    """Move-free, immutable owner of runtime facts.

    ``preferred_device`` may be a JAX platform name ("gpu", "cpu") or empty
    for the process default backend.
    """

    def __init__(self, options: ContextOptions | None = None):
        self._options = options or ContextOptions()
        platform = self._options.preferred_device or None
        try:
            if platform:
                self._devices = tuple(jax.devices(platform))
            else:
                self._devices = tuple(jax.devices())
        except RuntimeError as exc:
            raise DvrenError.unsupported(
                f"no devices for platform "
                f"'{self._options.preferred_device}': {exc}") from exc
        if not self._devices:
            raise DvrenError.unsupported("no JAX devices available")

    @staticmethod
    def create(options: ContextOptions | None = None) -> "Context":
        return Context(options)

    @property
    def options(self) -> ContextOptions:
        return self._options

    @property
    def devices(self) -> tuple[jax.Device, ...]:
        return self._devices

    @property
    def device(self) -> jax.Device:
        return self._devices[0]

    @property
    def platform(self) -> str:
        return self.device.platform

    @property
    def version(self) -> tuple[int, int, int]:
        return (VERSION_MAJOR, VERSION_MINOR, VERSION_PATCH)

    def valid(self) -> bool:
        return bool(self._devices)
