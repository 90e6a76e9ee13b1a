"""A configuration's scene through the renderer's public scene API.

The same description and the same files that the reference reads: the
benchmark builds the scene itself (no scene module of the renderer), so
both sides start from the same inputs.
"""

from __future__ import annotations


def build(config: dict, camera: dict, files: dict):
    import cs397raytracingsp22_tpu_torch as rt

    from benchmark.reference.scene import transform_matrix

    desc = config["scene"]
    kinds = {"lambertian": lambda m: rt.Lambertian(albedo=tuple(m["albedo"]),
                                                  emission=tuple(m.get("emission", (0, 0, 0)))),
             "metal": lambda m: rt.Metal(albedo=tuple(m["albedo"]), roughness=m.get("roughness", 0.0)),
             "dielectric": lambda m: rt.Dielectric(idx_of_refraction=m["ior"]),
             "parameterized": lambda m: rt.ParameterizedMaterial(
                 albedo=tuple(m["albedo"]), roughness=m.get("roughness", 0.0),
                 metallic=m.get("metallic", 0.0)),
             "isotropic": lambda m: rt.Isotropic(albedo=tuple(m["albedo"]))}
    mats = {name: kinds[m["type"]](m) for name, m in desc["materials"].items()}
    objects = []
    for obj in desc["objects"]:
        kind = obj["type"]
        if kind == "sphere":
            objects.append(rt.Sphere(center=tuple(obj["center"]), radius=obj["radius"],
                                     material=mats[obj["material"]]))
        elif kind == "plane":
            objects.append(rt.Plane(point=tuple(obj["point"]), normal=tuple(obj["normal"]),
                                    material=mats[obj["material"]]))
        elif kind == "triangle":
            objects.append(rt.Triangle(a=tuple(obj["a"]), b=tuple(obj["b"]), c=tuple(obj["c"]),
                                       material=mats[obj["material"]]))
        elif kind == "volume":
            b = obj["boundary"]
            objects.append(rt.ConvexVolume(
                boundary=rt.Sphere(center=tuple(b["center"]), radius=b["radius"],
                                   material=rt.Dielectric(idx_of_refraction=1.5)),
                phase_function=mats[obj["phase"]], density=obj["density"]))
        elif kind == "mesh":
            tex = {f"{slot}_path": files[name] for slot, name in obj.get("textures", {}).items()}
            objects.append(rt.StaticMesh.load_from_file(
                files[obj["obj"]], material=mats[obj["material"]] if obj.get("material") else None,
                transform=transform_matrix(obj.get("transform", [])), **tex))
        else:
            raise ValueError(f"unknown object type {kind!r}")
    cam = rt.Camera(
        eyepoint=tuple(camera["eyepoint"]), view_dir=tuple(camera["view_dir"]),
        up=tuple(camera["up"]), focal_length=camera["focal_length"],
        focus_dist=camera["focus_dist"], lens_radius=camera.get("lens_radius", 0.0),
        screen_width=camera["screen_width"], screen_height=camera["screen_height"],
        aa_sample_count=camera["aa_sample_count"], path_depth=camera["path_depth"],
        path_samples=1, max_trace_dist=camera["max_trace_dist"], gamma=camera["gamma"],
        nee=camera.get("nee", False))
    return rt.Scene(camera=cam, objects=objects)
