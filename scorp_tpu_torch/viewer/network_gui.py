"""SIBR remote-viewer socket bridge, port of `scorp_tpu.viewer.network_gui`.

The reference's network_gui wire protocol: a little-endian u32 length and a
JSON request carrying resolution, fields of view, flags and the row-major
view and view-projection matrices (their Y and Z, resp. Y, columns
negated on receipt), answered with the raw HWC u8 RGB frame and a
length-prefixed verify string. Both trainers run `gui_tick` once per
iteration under --gui (the reference's live call site is its 2DGS trainer;
its 3DGS one ships the hook commented out). Host code: the trainer's
`render_fn` renders on its device and returns a host array.
"""

from __future__ import annotations

import json
import socket
import traceback

import numpy as np

from ..scene.cameras import MiniCam


class NetworkGUI:
    def __init__(self):
        self.host = "127.0.0.1"
        self.port = 6009
        self.conn: socket.socket | None = None
        self.addr = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)

    def init(self, wish_host: str, wish_port: int):
        self.host = wish_host
        self.port = wish_port
        self.listener.bind((self.host, self.port))
        self.listener.listen()
        self.listener.settimeout(0)

    def close(self):
        """Close the viewer's connection and the listening socket."""
        if self.conn is not None:
            self.conn.close()
            self.conn = None
        self.listener.close()

    def try_connect(self):
        try:
            self.conn, self.addr = self.listener.accept()
            print(f"\nConnected by {self.addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, OSError):
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def read(self) -> dict:
        length = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(length).decode("utf-8"))

    def send(self, image_bytes: bytes | None, verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self):
        """Returns (MiniCam|None, do_training, shs_python, rot_scale_python,
        keep_alive, scaling_modifier)."""
        message = self.read()
        width = message["resolution_x"]
        height = message["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None, None
        try:
            do_training = bool(message["train"])
            fovy = message["fov_y"]
            fovx = message["fov_x"]
            znear = message["z_near"]
            zfar = message["z_far"]
            do_shs_python = bool(message["shs_python"])
            do_rot_scale_python = bool(message["rot_scale_python"])
            keep_alive = bool(message["keep_alive"])
            scaling_modifier = message["scaling_modifier"]
            wvt = np.asarray(message["view_matrix"], np.float32).reshape(4, 4)
            wvt[:, 1] = -wvt[:, 1]
            wvt[:, 2] = -wvt[:, 2]
            fpt = np.asarray(message["view_projection_matrix"], np.float32).reshape(4, 4)
            fpt[:, 1] = -fpt[:, 1]
            cam = MiniCam(width, height, fovy, fovx, znear, zfar, wvt, fpt)
        except Exception:
            traceback.print_exc()
            raise
        return cam, do_training, do_shs_python, do_rot_scale_python, keep_alive, scaling_modifier

    @staticmethod
    def encode_image(render: np.ndarray) -> bytes:
        """[3,H,W] float render -> raw HWC u8 bytes for the viewer."""
        img = (np.clip(render, 0.0, 1.0) * 255).astype(np.uint8)
        return memoryview(np.ascontiguousarray(img.transpose(1, 2, 0))).tobytes()


def gui_tick(gui: NetworkGUI, render_fn, source_path: str,
             iteration: int, max_iterations: int) -> None:
    """One viewer service round, the reference's in-loop protocol: accept a
    pending connection, then answer view requests until the viewer either
    releases training (`train` with the run unfinished) or disconnects.

    render_fn(minicam, scaling_modifier) -> [3, H, W] float host image.
    """
    if gui.conn is None:
        gui.try_connect()
    while gui.conn is not None:
        try:
            net_image_bytes = None
            (cam, do_training, _shs_python, _rot_scale_python,
             keep_alive, scaling_mod) = gui.receive()
            if cam is not None:
                net_image_bytes = gui.encode_image(render_fn(cam, scaling_mod))
            gui.send(net_image_bytes, source_path)
            if do_training and (iteration < int(max_iterations) or not keep_alive):
                break
        except Exception:
            # the viewer went away (or sent garbage): drop it, keep training
            conn, gui.conn = gui.conn, None
            conn.close()


def maybe_create_gui(ip: str | None, port: int | None) -> NetworkGUI | None:
    """Bind the viewer socket; on failure (port taken) warn and disable."""
    if ip is None:
        return None
    gui = NetworkGUI()
    try:
        gui.init(ip, int(port))
        return gui
    except OSError as e:
        gui.close()
        print(f"[network_gui] disabled: could not bind {ip}:{port} ({e})")
        return None
