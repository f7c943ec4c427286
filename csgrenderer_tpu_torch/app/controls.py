"""Interactive input — the headless analog of the reference's event poll.

Twin of ``csgrenderer_tpu/app/controls.py``. The reference polls
window/keyboard events every frame and exits when the window closes
(the reference's app.c:204 ``glfwPollEvents``, app.c:136
``glfwWindowShouldClose``). A display-less GPU host has no window, so
events arrive over the preview server's ``/input`` endpoint
(app/preview.py: the browser page sends drag/wheel/key events) and are
drained here at the App's fixed update rate — the same cadence contract as
the reference's per-frame poll.

``OrbitController`` is the standard spherical-orbit camera rig:

- drag          -> yaw/pitch around the target
- wheel / +,-   -> dolly (distance)
- arrow keys    -> yaw/pitch steps
- Escape / q    -> stop the App (the window-close analog)

``attach(app, renderer, server, controller)`` wires everything: an App
``update_cb`` that polls the server's event queue, updates the rig, and
swaps the renderer's camera (``PathTraceRenderer.set_camera``: the next
frame packs the new camera, nothing is rebuilt). The rig's cameras are made
on the CPU; the renderer moves each to its device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..camera.pinhole import Camera

_KEY_STEPS = {
    "ArrowLeft": (-0.08, 0.0, 0.0),
    "ArrowRight": (0.08, 0.0, 0.0),
    "ArrowUp": (0.0, 0.06, 0.0),
    "ArrowDown": (0.0, -0.06, 0.0),
    "+": (0.0, 0.0, -0.5),
    "=": (0.0, 0.0, -0.5),
    "-": (0.0, 0.0, 0.5),
}


@dataclass
class OrbitController:
    """Spherical orbit rig around ``target``; emits ``Camera`` objects.

    Angles in radians; ``yaw``/``pitch`` rotate the eye around the target
    at ``distance``. Construct with ``from_camera`` to start exactly at an
    existing look_at pose.
    """

    target: tuple = (0.0, 0.0, 0.0)
    distance: float = 10.0
    yaw: float = 0.0
    pitch: float = 0.2
    vfov_degrees: float = 40.0
    aspect_ratio: float = 16.0 / 9.0
    aperture: float = 0.0
    focus_dist: float | None = None
    min_distance: float = 0.5
    dirty: bool = field(default=True, init=False)

    @staticmethod
    def from_camera(lookfrom, lookat, vfov_degrees, aspect_ratio,
                    aperture: float = 0.0,
                    focus_dist: float | None = None) -> "OrbitController":
        dx = lookfrom[0] - lookat[0]
        dy = lookfrom[1] - lookat[1]
        dz = lookfrom[2] - lookat[2]
        dist = math.sqrt(dx * dx + dy * dy + dz * dz)
        return OrbitController(
            target=tuple(float(c) for c in lookat),
            distance=dist,
            yaw=math.atan2(dx, dz),
            pitch=math.asin(dy / dist) if dist > 0 else 0.0,
            vfov_degrees=vfov_degrees,
            aspect_ratio=aspect_ratio,
            aperture=aperture,
            focus_dist=focus_dist,
        )

    # -- event application -------------------------------------------------

    def orbit(self, dyaw: float, dpitch: float, dzoom: float = 0.0) -> None:
        self.yaw = (self.yaw + dyaw) % (2.0 * math.pi)
        limit = 0.49 * math.pi  # keep off the pole (vup degeneracy)
        self.pitch = max(-limit, min(limit, self.pitch + dpitch))
        self.distance = max(self.min_distance, self.distance + dzoom)
        self.dirty = True

    def handle(self, event: dict) -> str | None:
        """Apply one preview-server event; returns "close" for the
        window-close analog (Escape / q / the close event), else None."""
        etype = event.get("type")
        if etype == "close":
            return "close"
        if etype == "orbit":
            self.orbit(
                float(event.get("dyaw", 0.0)),
                float(event.get("dpitch", 0.0)),
                float(event.get("dzoom", 0.0)),
            )
            return None
        if etype == "key":
            code = event.get("code", "")
            if code in ("Escape", "q"):
                return "close"
            step = _KEY_STEPS.get(code)
            if step is not None:
                self.orbit(*step)
            return None
        return None

    def camera(self) -> Camera:
        cp = math.cos(self.pitch)
        eye = (
            self.target[0] + self.distance * cp * math.sin(self.yaw),
            self.target[1] + self.distance * math.sin(self.pitch),
            self.target[2] + self.distance * cp * math.cos(self.yaw),
        )
        self.dirty = False
        return Camera.look_at(
            eye,
            self.target,
            vfov_degrees=self.vfov_degrees,
            aspect_ratio=self.aspect_ratio,
            aperture=self.aperture,
            focus_dist=(
                self.focus_dist if self.focus_dist is not None
                else self.distance
            ),
        )


def attach(app, renderer, server, controller: OrbitController):
    """Wire browser input into the App loop (see module docstring).

    Installs an ``update_cb`` on ``app`` that drains ``server``'s event
    queue each fixed-timestep tick, applies events to ``controller``, and
    swaps ``renderer``'s camera when the rig moved. A close event (or
    Escape/q) stops the App — the reference's window-close exit
    (app.c:136). Returns the callback for testing/chaining.
    """

    def update(app_, dt):
        for ev in server.poll_events():
            if controller.handle(ev) == "close":
                app_.stop()
        if controller.dirty:
            renderer.set_camera(controller.camera())

    prior = app.update_cb

    def chained(app_, dt):
        if prior is not None:
            prior(app_, dt)
        update(app_, dt)

    app.update_cb = chained if prior is not None else update
    return app.update_cb
