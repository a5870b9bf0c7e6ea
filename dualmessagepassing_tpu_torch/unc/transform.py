"""UNC Transform stage: HIN raw format -> model input files. A copy of
dualmessagepassing_tpu/unc/transform.py (host code, no jax), which the
JAX package's __init__ keeps out of reach on a machine without jax.

Reference: UnsupervisedNodeClassification/Transform/
transform_model.py (rgcn_convert 244-286, seed_node_generate 13-38; the
dmpnn/compgcn/rgin converts are copies of rgcn_convert).

Raw HIN format (Data/README.md:14-65):
  node.dat   : id \t name \t type [\t attributes(comma-sep)]
  link.dat   : src \t dst \t ltype \t weight
  label.dat  : id \t name \t type \t label        (+ label.dat.test)
  link.dat.test : left \t right \t 0/1
  meta.dat   : "Node Total_...: count" / "Edge Type_k: count" lines

Model format:
  link.dat   : "{num_nodes} {num_rels}\n" then "src ltype dst" rows
  node.dat   : "id\tattr,attr,..." (attributed only)
  label.dat  : "id\tlabel" (supervised only)
  seed_node.dat : sorted node ids appearing in eval files
"""

from __future__ import annotations

import os


def seed_node_generate(data_dir: str, out_dir: str):
    """Nodes appearing in link.dat.test / label.dat / label.dat.test
    (transform_model.py:13-38)."""
    seeds = set()
    lt = os.path.join(data_dir, "link.dat.test")
    if os.path.exists(lt):
        with open(lt) as f:
            for line in f:
                left, right, _ = line.rstrip("\n").split("\t")
                seeds.add(int(left))
                seeds.add(int(right))
    for name in ("label.dat", "label.dat.test"):
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            with open(p) as f:
                for line in f:
                    seeds.add(int(line.rstrip("\n").split("\t")[0]))
    with open(os.path.join(out_dir, "seed_node.dat"), "w") as f:
        for n in sorted(seeds):
            f.write(f"{n}\n")


def transform(data_dir: str, out_dir: str, attributed: bool = False,
              supervised: bool = False):
    """rgcn_convert / dmpnn_convert (transform_model.py:244-356)."""
    os.makedirs(out_dir, exist_ok=True)
    entity_count, relation_count = 0, 0
    with open(os.path.join(data_dir, "meta.dat")) as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 4:
                continue
            entity, info = parts[0], parts[1][:-1].split("_")
            if entity == "Node" and info[0] == "Total":
                entity_count = int(parts[3])
            elif entity == "Edge" and info[0] == "Type":
                relation_count += 1

    with open(os.path.join(out_dir, "link.dat"), "w") as out:
        out.write(f"{entity_count} {relation_count}\n")
        with open(os.path.join(data_dir, "link.dat")) as f:
            for line in f:
                left, right, ltype, _w = line.rstrip("\n").split("\t")
                out.write(f"{left} {ltype} {right}\n")

    if attributed:
        with open(os.path.join(out_dir, "node.dat"), "w") as out:
            with open(os.path.join(data_dir, "node.dat")) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    out.write(f"{parts[0]}\t{parts[3]}\n")

    if supervised:
        with open(os.path.join(out_dir, "label.dat"), "w") as out:
            with open(os.path.join(data_dir, "label.dat")) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    out.write(f"{parts[0]}\t{parts[3]}\n")

    seed_node_generate(data_dir, out_dir)
