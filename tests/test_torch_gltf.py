"""The port's glTF loader and writer (`optixpathtracer_tpu_torch/scene/
gltf.py`) against the JAX package's.

Assets: tests/test_real_asset.py's byte-built .glb (a node hierarchy that
composes, interleaved attributes, uint16 indices, an embedded PNG with an
alpha checkerboard), `save_gltf` files of presets, and edits of them
(uint16 indices, data: and external images, child nodes).

Tolerance: the loaded Models equal the reference's array for array, bit
for bit (both are the same numpy code). The flattened .glb renders by the
engine-golden criterion of tests/test_torch_render.py against the
reference run op by op.
"""
import base64
import json

import jax
import numpy as np
import pytest
import torch

from optixpathtracer_tpu.camera import Camera as JCamera
from optixpathtracer_tpu.integrate import render as jrender
from optixpathtracer_tpu.scene import PointLight as JPointLight
from optixpathtracer_tpu.scene import flatten_model as jflatten
from optixpathtracer_tpu.scene.gltf import load_gltf as jload_gltf
from optixpathtracer_tpu.scene.gltf import save_gltf as jsave_gltf
from optixpathtracer_tpu.scene.procedural import PRESETS as JPRESETS
from optixpathtracer_tpu_torch.camera import Camera
from optixpathtracer_tpu_torch.integrate import path
from optixpathtracer_tpu_torch.integrate.cutout import \
    scene_uses_alpha_cutout
from optixpathtracer_tpu_torch.scene import (Material, Mesh, Model,
                                             PointLight, flatten_model)
from optixpathtracer_tpu_torch.scene.gltf import load_gltf, save_gltf
from optixpathtracer_tpu_torch.scene.procedural import PRESETS, uv_sphere
from test_real_asset import _png_bytes, build_glb

torch.set_num_threads(1)


def assert_models_equal(got, want):
    assert len(got.meshes) == len(want.meshes)
    for a, b in zip(got.meshes, want.meshes):
        assert a.name == b.name
        for f in ("positions", "indices", "normals", "uvs", "translation",
                  "rotation_quat", "scale"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
        ma, mb = a.material, b.material
        np.testing.assert_array_equal(ma.base_color, mb.base_color)
        for f in ("metallic", "roughness", "ior", "mat_type",
                  "albedo_texture", "metal_rough_texture",
                  "normal_texture"):
            assert getattr(ma, f) == getattr(mb, f), f
    assert len(got.textures) == len(want.textures)
    for a, b in zip(got.textures, want.textures):
        assert a.name == b.name
        np.testing.assert_array_equal(a.pixels, b.pixels)


@pytest.fixture(scope="module")
def glb(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("asset") / "leaf.glb")
    build_glb(p)
    return p


@pytest.mark.parametrize("compat", [False, True])
def test_glb_loads_as_reference(glb, compat):
    got = load_gltf(glb, reference_compat=compat)
    assert_models_equal(got, jload_gltf(glb, reference_compat=compat))
    # the hierarchy composes (root T, mid S, leaf T) unless compat
    names = [m.name for m in got.meshes]
    assert names == (["floor"] if compat else ["leaf", "floor"])
    if not compat:
        np.testing.assert_allclose(got.meshes[0].positions[0],
                                   [0.0, 2.0, -0.5], atol=1e-6)
        assert got.meshes[0].indices.dtype == np.int32
        tex = got.textures[0].pixels  # not y-mirrored
        assert tex.shape == (8, 8, 4)
        assert tex[0, 0, 3] == 0.0 and tex[0, 1, 3] == 1.0


def test_glb_flattens_and_renders_as_reference(glb):
    model, jmodel = load_gltf(glb), jload_gltf(glb)
    light = (np.array([0.5, 5.0, 0.0]), np.ones(3) * 20.0)
    scene = flatten_model(model, [PointLight(*light)], device="cpu")
    jscene = jflatten(jmodel, [JPointLight(*light)])
    assert scene_uses_alpha_cutout(scene)
    assert int(scene.tri_valid.sum()) == 4
    pose = dict(position=np.array([0.5, 4.0, 2.5]),
                rotation=np.array([55.0, 180.0, 0.0]))
    img = path.render(scene, Camera(**pose), 16, 16, spp=1,
                      max_bounces=2).numpy()
    with jax.disable_jit():
        want = np.asarray(jrender(jscene, JCamera(**pose), 16, 16, spp=1,
                                  max_bounces=2, intersect_method="brute"))
    assert img.max() > 0 and np.isfinite(img).all()
    close = np.isclose(img, want, atol=1e-5, rtol=1e-4).all(axis=-1)
    assert close.mean() > 0.995, close.mean()
    np.testing.assert_allclose(img.mean(), want.mean(), rtol=1e-3)


@pytest.mark.parametrize("preset", ["scene3_cornell", "conductor"])
def test_save_gltf_round_trips_as_reference(tmp_path, preset):
    """The port's writer gives the reference's document (bar the
    generator), and both loaders read either writer's file the same."""
    model, _, _ = PRESETS[preset]()
    jmodel, _, _ = JPRESETS[preset]()
    ours, theirs = str(tmp_path / "port.gltf"), str(tmp_path / "ref.gltf")
    save_gltf(ours, model)
    jsave_gltf(theirs, jmodel)
    a, b = json.load(open(ours)), json.load(open(theirs))
    assert a["asset"]["generator"] == "optixpathtracer_tpu_torch"
    a["asset"]["generator"] = b["asset"]["generator"]
    assert a == b
    for p in (ours, theirs):
        assert_models_equal(load_gltf(p), jload_gltf(p))
    back = load_gltf(ours)
    assert len(back.meshes) == len(model.meshes)
    for m, orig in zip(back.meshes, model.meshes):
        mm = orig.model_matrix()
        world = (orig.positions.astype(np.float64) @ mm[:3, :3].T
                 + mm[:3, 3]).astype(np.float32)
        np.testing.assert_array_equal(m.positions, world)
        np.testing.assert_array_equal(m.indices, orig.indices)
        assert m.material.mat_type == orig.material.mat_type


def test_sphere_round_trip(tmp_path):
    mesh = uv_sphere(0.5, (1.0, 2.0, 3.0), 8, 16,
                     Material(base_color=np.array([0.8, 0.2, 0.1],
                                                  np.float32),
                              metallic=0.7, roughness=0.3,
                              mat_type="conductor"))
    p = str(tmp_path / "sphere.gltf")
    save_gltf(p, Model(meshes=[mesh]))
    back = load_gltf(p)
    m = back.meshes[0]
    np.testing.assert_allclose(m.positions, mesh.positions, atol=1e-5)
    np.testing.assert_allclose(m.normals, mesh.normals, atol=1e-5)
    assert m.material.mat_type == "conductor"
    assert m.material.metallic == pytest.approx(0.7)
    assert_models_equal(back, jload_gltf(p))


def _one_triangle_doc(tmp_path):
    mesh = Mesh(
        positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        indices=np.array([[0, 1, 2]], np.int32),
        uvs=np.array([[0, 0], [1, 0], [0, 1]], np.float32))
    p = str(tmp_path / "tri.gltf")
    save_gltf(p, Model(meshes=[mesh]))
    return p, json.load(open(p))


def test_uint16_indices_and_children(tmp_path):
    p, doc = _one_triangle_doc(tmp_path)
    blob = bytearray(base64.b64decode(
        doc["buffers"][0]["uri"].split(",", 1)[1]))
    for acc in doc["accessors"]:
        if acc["type"] == "SCALAR":
            view = doc["bufferViews"][acc["bufferView"]]
            idx = np.frombuffer(bytes(blob), np.uint32, acc["count"],
                                view["byteOffset"])
            new = idx.astype(np.uint16).tobytes()
            blob[view["byteOffset"]:view["byteOffset"] + len(new)] = new
            view["byteLength"] = len(new)
            acc["componentType"] = 5123
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(bytes(blob)).decode())
    # a parent that translates and rotates its child
    doc["nodes"] = [{"name": "parent", "translation": [5.0, 0.0, 0.0],
                     "rotation": [0.0, 0.7071068, 0.0, 0.7071068],
                     "children": [1]}, doc["nodes"][0]]
    doc["scenes"][0]["nodes"] = [0]
    json.dump(doc, open(p, "w"))
    got = load_gltf(p)
    assert_models_equal(got, jload_gltf(p))
    np.testing.assert_array_equal(got.meshes[0].indices, [[0, 1, 2]])
    np.testing.assert_allclose(got.meshes[0].positions[0], [5.0, 0.0, 0.0],
                               atol=1e-6)
    assert len(load_gltf(p, reference_compat=True).meshes) == 0


@pytest.mark.parametrize("where", ["data_uri", "file"])
def test_images_by_uri(tmp_path, where):
    """Textures from a data: URI and from a file next to the .gltf."""
    p, doc = _one_triangle_doc(tmp_path)
    rgba = np.random.default_rng(3).integers(0, 256, (4, 6, 4), np.uint8)
    png = _png_bytes(rgba)
    if where == "file":
        (tmp_path / "tex.png").write_bytes(png)
        uri = "tex.png"
    else:
        uri = "data:image/png;base64," + base64.b64encode(png).decode()
    doc["images"] = [{"uri": uri}]
    doc["textures"] = [{"source": 0}]
    doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
        "index": 0}
    json.dump(doc, open(p, "w"))
    got = load_gltf(p)
    assert_models_equal(got, jload_gltf(p))
    np.testing.assert_array_equal(got.textures[0].pixels,
                                  rgba.astype(np.float32) / 255.0)
    assert got.meshes[0].material.albedo_texture == 0
