"""Frames of env states, drawn on the host with NumPy (JAX ``render.py``).

The reference renders with pygame and sprite images that its repo does not
ship (dmfb.py:698,709).  As in the JAX package, frames are drawn
procedurally: each cell shaded by its electrode's health (the MEDA
Viewer's, meda.py:727-736), droplets and goals in the reference's color
table (dmfb.py:520-542), DMFB droplets as points and MEDA ones as 5x5
bodies.

* ``Renderer.draw(state, index=0) -> (H, W, 3) uint8`` frame of one chip of
  a batched state, read off the card first;
* ``show=True``: a live pygame window;
* ``save_path``: an mp4 written with OpenCV (``cv2``).

``cv2`` and ``pygame`` are imported only when a video or a window is
asked for; where they are not installed, that raises ``ImportError``
naming the package.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

# The reference's color table (dmfb.py:520-542), RGB in [0, 1].
COLOR_TABLE = np.array([
    [0.98039216, 0.92156863, 0.84313725],
    [0.0, 1.0, 1.0],
    [0.49803922, 1.0, 0.83137255],
    [0.39215686, 0.58431373, 0.92941176],
    [0.33333333, 0.41960784, 0.18431373],
    [0.96078431, 0.96078431, 0.8627451],
    [1.0, 0.89411765, 0.76862745],
    [0.0, 0.0, 1.0],
    [0.54117647, 0.16862745, 0.88627451],
    [0.64705882, 0.16470588, 0.16470588],
    [0.87058824, 0.72156863, 0.52941176],
    [0.8627451, 0.07843137, 0.23529412],
    [0.0, 0.0, 0.54509804],
    [0.0, 0.54509804, 0.54509804],
    [0.0, 0.39215686, 0.0],
    [0.54509804, 0.0, 0.54509804],
    [1.0, 0.54901961, 0.0],
    [0.37254902, 0.61960784, 0.62745098],
    [0.49803922, 1.0, 0.0],
    [1.0, 0.49803922, 0.31372549],
    [0.54509804, 0.0, 0.0],
])


def _import(name: str, what: str):
    """The optional package ``name``, or ``ImportError`` saying that
    ``what`` needs it."""
    try:
        return __import__(name)
    except ImportError as e:
        raise ImportError(f"{what} needs the '{name}' package, which is not "
                          "installed here") from e


def _host(x, index: int) -> np.ndarray:
    """Chip ``index`` of a batched tensor field, as a NumPy array."""
    return x[index].detach().cpu().numpy()


class Renderer:
    def __init__(self, env, u_size: int = 40, show: bool = False,
                 save_path: Optional[str] = None, fps: int = 12):
        self.env = env
        self.name = env.name
        p = env.params
        self.w, self.l = p.width, p.length
        # cap the window as the MEDA Viewer does (meda.py:689-695)
        if max(self.w, self.l) * u_size > 1400:
            u_size = 1400 // max(self.w, self.l)
        self.u = u_size
        self.n = p.n_droplets
        self.screen = None
        self.video = None
        self.show = show
        if save_path is not None:
            cv2 = _import("cv2", "writing a video (--show_save)")
            os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
            if not os.path.splitext(save_path)[1]:
                save_path = os.path.join(
                    save_path,
                    f"{self.w}by{self.l}-{self.n}d{int(time.time())}.mp4")
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            self.video = cv2.VideoWriter(save_path, fourcc, fps,
                                         (self.l * self.u, self.w * self.u))
            self.video_path = save_path

    # -- frame construction --------------------------------------------
    def _cell_canvas(self, health: np.ndarray) -> np.ndarray:
        """The board: each cell 100 + 155 * health bright, with dark
        borders (the MEDA Viewer's drawcell, meda.py:727-736)."""
        u = self.u
        H = (100 + 155 * np.clip(health, 0, 1)).astype(np.uint8)
        canvas = np.repeat(np.repeat(H, u, axis=0), u, axis=1)
        canvas = np.stack([canvas] * 3, axis=-1)
        canvas[::u, :, :] = 30
        canvas[:, ::u, :] = 30
        return canvas

    def _blit_cell(self, canvas, x, y, color, inset=4, shape="circle"):
        """Paint a cell-sized sprite at board cell (x, y); the canvas is
        row = y, column = x."""
        u = self.u
        r0, c0 = y * u, x * u
        patch = canvas[r0:r0 + u, c0:c0 + u]
        yy, xx = np.mgrid[0:u, 0:u]
        if shape == "circle":
            m = (yy - u / 2) ** 2 + (xx - u / 2) ** 2 <= (u / 2 - inset) ** 2
        elif shape == "ring":
            d = (yy - u / 2) ** 2 + (xx - u / 2) ** 2
            m = (d <= (u / 2 - inset) ** 2) & (d >= (u / 2 - inset * 2.5) ** 2)
        else:   # square
            m = ((yy >= inset) & (yy < u - inset) & (xx >= inset)
                 & (xx < u - inset))
        patch[m] = (np.asarray(color) * 255).astype(np.uint8)

    def draw(self, state, index: int = 0) -> np.ndarray:
        """The frame of chip ``index`` of a batched env state."""
        if self.name == "dmfb":
            frame = self._cell_canvas(_host(state.health, index).T)
            for x, y in zip(*np.nonzero(_host(state.block_mask, index))):
                self._blit_cell(frame, x, y, (0.15, 0.15, 0.15), inset=2,
                                shape="square")
            goals, pos = _host(state.goal, index), _host(state.pos, index)
            for i in range(self.n):
                c = COLOR_TABLE[i % len(COLOR_TABLE)]
                self._blit_cell(frame, goals[i, 0], goals[i, 1], c,
                                shape="ring")
            for i in range(self.n):
                c = COLOR_TABLE[i % len(COLOR_TABLE)]
                self._blit_cell(frame, pos[i, 0], pos[i, 1], c,
                                shape="circle")
        else:   # MEDA: boards indexed [y][x], square bodies of radius 2
            frame = self._cell_canvas(_host(state.health, index))
            r = 2
            dests = _host(state.dest, index)
            centers = _host(state.center, index)
            for i in range(self.n):
                c = COLOR_TABLE[i % len(COLOR_TABLE)]
                for dy in range(-r, r + 1):
                    for dx in range(-r, r + 1):
                        self._blit_cell(frame, dests[i, 0] + dx,
                                        dests[i, 1] + dy, c, inset=6,
                                        shape="ring")
            for i in range(self.n):
                c = COLOR_TABLE[i % len(COLOR_TABLE)]
                for dy in range(-r, r + 1):
                    for dx in range(-r, r + 1):
                        self._blit_cell(frame, centers[i, 0] + dx,
                                        centers[i, 1] + dy, c, inset=2,
                                        shape="square")
        if self.video is not None:
            cv2 = _import("cv2", "writing a video (--show_save)")
            self.video.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        if self.show:
            self._pygame_blit(frame)
        return frame

    def _pygame_blit(self, frame):
        pygame = _import("pygame", "a live window (--show)")
        if self.screen is None:
            pygame.init()
            self.screen = pygame.display.set_mode((frame.shape[1],
                                                   frame.shape[0]))
        surf = pygame.surfarray.make_surface(frame.transpose(1, 0, 2))
        self.screen.blit(surf, (0, 0))
        pygame.display.flip()

    def close(self):
        if self.video is not None:
            self.video.release()
            self.video = None
        if self.screen is not None:
            _import("pygame", "a live window (--show)").display.quit()
            self.screen = None


def render_episode(env, states_sequence, **kwargs) -> list:
    """The frames of a trajectory (a list of batched states, chip 0 of
    each): simulate on the device, draw on the host."""
    r = Renderer(env, **kwargs)
    frames = [r.draw(s) for s in states_sequence]
    r.close()
    return frames
