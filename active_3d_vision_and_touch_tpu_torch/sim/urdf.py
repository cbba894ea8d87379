"""URDF export for interoperability with external physics engines.

The port's copy of the JAX package's ``sim/urdf.py``.

Our simulator consumes meshes directly, but datasets generated here remain
loadable by Bullet-style tooling: every object can be wrapped in a minimal
URDF referencing its OBJ (the reference templated ``blank.urdf`` per object,
``utility/utils.py:359-371``), and the procedural hand can be exported as a
fixed-joint URDF snapshot of its current pose.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np


def _mesh_link(name: str, obj_filename: str) -> ET.Element:
    link = ET.Element("link", name=name)
    for tag in ("visual", "collision"):
        section = ET.SubElement(link, tag)
        geometry = ET.SubElement(section, "geometry")
        ET.SubElement(geometry, "mesh", filename=obj_filename)
    inertial = ET.SubElement(link, "inertial")
    ET.SubElement(inertial, "mass", value="0")
    ET.SubElement(
        inertial,
        "inertia",
        ixx="0", ixy="0", ixz="0", iyy="0", iyz="0", izz="0",
    )
    return link


def export_object_urdf(obj_path: str, urdf_path: str | None = None) -> str:
    """Write ``<name>.urdf`` referencing an existing OBJ file."""
    urdf_path = urdf_path or obj_path.replace(".obj", ".urdf")
    robot = ET.Element("robot", name=os.path.basename(urdf_path))
    robot.append(_mesh_link("base", os.path.abspath(obj_path)))
    ET.ElementTree(robot).write(urdf_path)
    return urdf_path


def export_hand_urdf(hand, directory: str) -> str:
    """Snapshot the hand's link meshes (current pose) into OBJs + one URDF
    of fixed joints — a portable record of a grasp configuration."""
    from active_3d_vision_and_touch_tpu_torch.core.mesh import save_obj

    os.makedirs(directory, exist_ok=True)
    robot = ET.Element("robot", name="a3vt_hand")
    prev = None
    for i, mesh in enumerate(hand.link_meshes()):
        obj_path = os.path.join(directory, f"link_{i}.obj")
        save_obj(obj_path, mesh.verts, mesh.faces)
        robot.append(_mesh_link(f"link_{i}", os.path.abspath(obj_path)))
        if prev is not None:
            joint = ET.SubElement(
                robot, "joint", name=f"fix_{i}", type="fixed"
            )
            ET.SubElement(joint, "parent", link=prev)
            ET.SubElement(joint, "child", link=f"link_{i}")
            ET.SubElement(joint, "origin", xyz="0 0 0", rpy="0 0 0")
        prev = f"link_{i}"
    urdf_path = os.path.join(directory, "hand.urdf")
    ET.ElementTree(robot).write(urdf_path)
    return urdf_path


def load_urdf_mesh_paths(urdf_path: str) -> list[str]:
    """Mesh filenames referenced by a URDF (loader-side counterpart)."""
    tree = ET.parse(urdf_path)
    return [
        m.attrib["filename"]
        for m in tree.getroot().iter("mesh")
        if "filename" in m.attrib
    ]
