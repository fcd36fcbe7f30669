"""First-contact validation kit for a real Inception graph and real data
(counterpart of tools/validate_real_assets.py of the JAX package).

The real `inceptionv1_for_inception_score.pb` and real TFDS shards are not
in the repository. The day they appear, this kit runs the first-contact
checks in one command and writes a pass/fail report:

  1. `--inception_pb`: convert the frozen graph to `.npz`
     (`inception_net.convert_frozen_graph`); the `.npz` and the graph
     itself (`make_graph_feature_fn`) must give the same pool_3 and logits
     on fixed inputs on --device, and the device must agree with the CPU.
  2. `--dataset` (with `--data_dir`): each record's decode must be what the
     pipeline's source yields (TFRecord shards: the record reread with both
     CRCs checked, parsed and decoded by `tf_io`; npz: the stored uint8
     scaled to [0, 1]); the train and eval streams must yield the declared
     shapes, the [0, 1] range and labels in bounds.
  3. Golden FID, with an Inception source: FID between two disjoint halves
     of the eval split must be below 0.25 of FID between real images and
     uniform noise.

The kit never imports TensorFlow (the card's machine has none). A caller
that has it passes it in as further oracles, as the JAX kit uses it:
`main(argv, feature_oracles={"tensorflow": fn}, record_oracles=...)`,
where a feature oracle maps (pb path, images in [0, 255]) to (pool_3,
logits) and a record oracle maps a serialized `tf.train.Example` to
(uint8 image, label). The report names the oracles each check used.

Usage:
  python -m compare_gan_torch.tools.validate_real_assets \
      --inception_pb /path/to/inceptionv1_for_inception_score.pb \
      --dataset cifar10 --data_dir /path/to/tensorflow_datasets \
      --workdir /tmp/validate [--report /tmp/validate/report.json] \
      [--device=cuda]

Exit code 0 only when every requested check passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# Bounds of the JAX kit: features of two implementations of one network.
FEATURE_RTOL, FEATURE_ATOL = 1e-3, 5e-3
DECODE_TOL = 1e-6


def _close(got, want):
    got_p, got_l = got
    want_p, want_l = want
    return (got_p.shape == want_p.shape and np.isfinite(got_p).all()
            and np.allclose(got_p, want_p, rtol=FEATURE_RTOL,
                            atol=FEATURE_ATOL)
            and np.allclose(got_l, want_l, rtol=FEATURE_RTOL,
                            atol=FEATURE_ATOL))


def _max_diff(a, b):
    return float(np.max(np.abs(a - b)))


def check_inception(pb_path, workdir, report, device="cuda",
                    feature_oracles=None):
    """pb -> npz, then the npz and the graph on `device`, the device
    against the CPU, and the CPU against each of `feature_oracles`."""
    from compare_gan_torch.metrics import inception_net

    npz = os.path.join(workdir, "inception_from_pb.npz")
    inception_net.convert_frozen_graph(pb_path, npz)
    imgs = (np.random.RandomState(0).rand(8, 64, 64, 3) * 255).astype(
        np.float32)
    pn, ln = inception_net.make_feature_fn(npz, device)(imgs)
    pg, lg = inception_net.make_graph_feature_fn(pb_path, device)(imgs)
    pc, lc = inception_net.make_feature_fn(npz, "cpu")(imgs)
    # The same weights through the same network on one device: equal.
    ok = bool(np.array_equal(pn, pg) and np.array_equal(ln, lg)
              and _close((pn, ln), (pc, lc)))
    detail = {
        "npz": npz, "pool_shape": list(pn.shape), "device": str(device),
        "oracles": ["graph", "cpu"],
        "max_abs_pool_diff_npz_vs_graph": _max_diff(pn, pg),
        "max_abs_pool_diff_device_vs_cpu": _max_diff(pn, pc),
        "max_abs_logits_diff_device_vs_cpu": _max_diff(ln, lc),
        "pool_scale": float(np.max(np.abs(pc)) + 1e-12)}
    for name, fn in (feature_oracles or {}).items():
        pt, lt = fn(pb_path, imgs)
        ok &= _close((pc, lc), (pt, lt))
        detail["oracles"].append(name)
        detail[f"max_abs_pool_diff_{name}"] = _max_diff(pc, pt)
        detail[f"max_abs_logits_diff_{name}"] = _max_diff(lc, lt)
    report["inception"] = {"ok": bool(ok), **detail}
    return ok, npz


def _tf_io_record(payload):
    """(uint8 image, label) of a serialized Example by `tf_io`'s parser
    and decoder; None for a record without image bytes."""
    from compare_gan_torch.tf_io import image_codec, protobuf

    feats = protobuf.parse_example(payload)
    for key in ("image", "image/encoded"):
        if key in feats and feats[key].bytes_list:
            encoded = feats[key].bytes_list[0]
            break
    else:
        return None
    label = 0
    for key in ("label", "image/class/label"):
        if key in feats and feats[key].int64_list:
            label = int(feats[key].int64_list[0])
            break
    return image_codec.decode_image(encoded), label


def check_dataset(name, num_examples, report, record_oracles=None):
    """Source decode against the oracles (for TFRecord shards: `tf_io` on
    the record reread with its CRCs checked, and `record_oracles`), then
    the transformed streams."""
    from compare_gan_torch import datasets
    from compare_gan_torch.tf_io import tfrecord

    oracles_of_record = {"tf_io": _tf_io_record, **(record_oracles or {})}
    ds = datasets.get_dataset(name)
    src = ds._get_source()
    detail = {"num_train": int(src.num_examples("train"))}
    ok = detail["num_train"] > 0

    n = min(num_examples, detail["num_train"])
    max_diff = 0.0
    oracles = set()
    for i in range(n):
        image, label, _ = src.get("train", i, seed=0)
        if isinstance(src, datasets.TFRecordSource):
            path, pos = src._index["train"][i]
            payload = next(tfrecord.iter_records(path, start=pos))
            wants = {k: fn(payload) for k, fn in oracles_of_record.items()}
            if any(want is None for want in wants.values()):
                detail.setdefault("records_missing_image_key", []).append(i)
                ok = False
                continue
        else:
            images, labels = src._load("train")
            wants = {"npz": (images[i], int(labels[i]))}
        for oracle, (want, want_label) in wants.items():
            oracles.add(oracle)
            if want.ndim == 2:
                want = want[:, :, None]
            want = want.astype(np.float32) / 255.0
            if image.shape != want.shape:
                ok = False
                continue
            max_diff = max(max_diff, _max_diff(image, want))
            ok &= label == want_label
    detail["decode_records_checked"] = n
    detail["decode_oracles"] = sorted(oracles)
    detail["max_abs_decode_diff"] = max_diff
    ok &= max_diff <= DECODE_TOL

    for split_desc, it in [
            ("train", ds._iter_examples(
                "train", shuffle=True, repeat=True,
                transform=ds._train_transform, seed=ds._seed,
                shard_by_host=False)),
            ("eval", ds._iter_examples(
                ds._resolve_eval_split(ds._eval_split),
                shuffle=False, repeat=False,
                transform=ds._eval_transform, seed=ds._seed,
                shard_by_host=False))]:
        shapes_ok = range_ok = labels_ok = True
        count = 0
        for image, label in it:
            shapes_ok &= tuple(image.shape) == tuple(ds.image_shape)
            range_ok &= bool(np.min(image) >= 0.0 and np.max(image) <= 1.0
                             and np.isfinite(image).all())
            if ds.num_classes:
                lab = int(np.argmax(label)) if np.ndim(label) else int(label)
                labels_ok &= 0 <= lab < ds.num_classes
            count += 1
            if count >= num_examples:
                it.close()
                break
        detail[split_desc] = {"checked": count, "shapes_ok": bool(shapes_ok),
                              "range_ok": bool(range_ok),
                              "labels_ok": bool(labels_ok)}
        ok &= shapes_ok and range_ok and labels_ok and count > 0
    report["dataset"] = {"ok": bool(ok), "name": name, **detail}
    return ok, ds


def check_golden_fid(ds, num_per_half, report, device="cuda"):
    """FID(real_A, real_B) must be below 0.25 of FID(noise, real_B)."""
    from compare_gan_torch import eval_utils
    from compare_gan_torch.metrics import fid_score

    split = ds._resolve_eval_split(ds._eval_split)
    imgs = ds.load_eval_images(2 * num_per_half,
                               failure_on_insufficient_examples=False)
    num_per_half = min(num_per_half, len(imgs) // 2)
    imgs = np.asarray(imgs, np.float32)
    half_a, half_b = imgs[:num_per_half], imgs[num_per_half:]
    noise = (np.random.RandomState(1)
             .rand(*half_b.shape).astype(np.float32) * 255.0)

    def feats(x):
        return eval_utils.inception_transform_np(x, device=device)[0]

    fid_rr = float(fid_score.compute_fid_from_activations(
        feats(half_a), feats(half_b)))
    fid_rn = float(fid_score.compute_fid_from_activations(
        feats(noise), feats(half_b)))
    ok = bool(np.isfinite(fid_rr) and np.isfinite(fid_rn)
              and fid_rr < 0.25 * fid_rn)
    report["golden_fid"] = {
        "ok": ok, "split": split, "num_per_half": len(half_a),
        "fid_real_real": fid_rr, "fid_real_noise": fid_rn}
    return ok


def main(argv=None, feature_oracles=None, record_oracles=None):
    """Run the checks the flags ask for; returns the exit code. The
    oracles are those of `check_inception` and `check_dataset`."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--inception_pb", help="Real frozen Inception graph.")
    p.add_argument("--dataset", help="Registered dataset name to validate.")
    p.add_argument("--data_dir", help="Real data root "
                   "(default: $COMPARE_GAN_DATA_DIR).")
    p.add_argument("--workdir", required=True)
    p.add_argument("--report", default=None,
                   help="Report JSON path (default: <workdir>/report.json).")
    p.add_argument("--num_examples", type=int, default=64,
                   help="Records per decode/stream check.")
    p.add_argument("--fid_samples", type=int, default=1024,
                   help="Images per half in the golden-FID check.")
    p.add_argument("--device", default="cuda",
                   help="torch device of the Inception network.")
    args = p.parse_args(argv)
    if not args.inception_pb and not args.dataset:
        p.error("Nothing to validate: pass --inception_pb and/or --dataset.")
    os.makedirs(args.workdir, exist_ok=True)
    from compare_gan_torch import datasets, eval_utils
    if args.data_dir:
        os.environ["COMPARE_GAN_DATA_DIR"] = args.data_dir
        datasets.DATA_DIR = args.data_dir

    report = {}
    all_ok = True
    if args.inception_pb:
        ok, npz = check_inception(args.inception_pb, args.workdir, report,
                                  args.device, feature_oracles)
        all_ok &= ok
        # The converted npz is the Inception source of the FID check, and
        # the file to point $COMPARE_GAN_INCEPTION_NPZ at afterwards.
        os.environ[eval_utils.INCEPTION_NPZ_ENV] = npz

    if args.dataset:
        ok, ds = check_dataset(args.dataset, args.num_examples, report,
                               record_oracles)
        all_ok &= ok
        has_inception = (os.environ.get(eval_utils.INCEPTION_NPZ_ENV)
                         or os.environ.get(eval_utils.INCEPTION_PB_ENV))
        if ok and has_inception:
            all_ok &= check_golden_fid(ds, args.fid_samples, report,
                                       args.device)
        elif not has_inception:
            report["golden_fid"] = {
                "ok": None,
                "skipped": "no Inception source (set --inception_pb or "
                           "$COMPARE_GAN_INCEPTION_NPZ/_PB)"}

    report["all_ok"] = bool(all_ok)
    report_path = args.report or os.path.join(args.workdir, "report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    for name, res in report.items():
        if isinstance(res, dict):
            status = {True: "PASS", False: "FAIL", None: "SKIP"}[res["ok"]]
            print(f"{status} {name}: "
                  f"{json.dumps({k: v for k, v in res.items() if k != 'ok'})}")
    print(("OK" if all_ok else "FAILED") + f" — report: {report_path}")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
