"""PyTorch/CUDA port: the image input pipeline against the JAX package, on
the CPU: ``mx.recordio``, ``mx.image``, ``io.ImageRecordIter``, the RecordIO
datasets, ``gluon.contrib.data.vision`` and ``tools/port_im2rec.py``.

Every comparison is bitwise, on images of at most 64 px and files of at
most 16 records, made from a numpy seed:

- record files written by either package are byte for byte the other's
  and each package reads the other's; ``pack_img``/``unpack_img`` on PNG
  and on a list label; a native build that fails raises ``MXNetError``
  with the compiler's output;
- every augmenter, and the ``CreateAugmenter``/``CreateDetAugmenter``
  pipelines, after the same ``mx.random.seed``; the image functions;
  ``ImageIter``;
- ``ImageRecordIter`` batches at 1 and 4 decode threads against the
  reference's at 1 (the reference's draws race between its threads; the
  port draws in record order on the caller's thread), two epochs; 50
  iterators opened and dropped leave the process's thread count where it
  was;
- ``RecordFileDataset``/``ImageRecordDataset``/``ImageListDataset``
  samples, and a dataset pickled for a worker;
- the five bbox Blocks under the same ``random.seed``, and
  ``ImageBboxDataLoader``'s padded batches;
- ``tools/port_im2rec.py``'s ``.lst``/``.rec``/``.idx`` against
  ``tools/im2rec.py``'s on one folder;
- the slice as a whole: a two-stage thumbnail ResNet v1 trained two SGD
  steps on batches that each package's ``ImageRecordIter`` reads from one
  ``.rec``, from the reference's ``.params``: losses within ``LOSS_RTOL``
  (1e-5: the two packages' convolutions sum in another order).

The ``cuda`` test lands an ``ImageRecordIter`` batch on the card equal to
the host's.
"""
import importlib.util
import os
import pickle
import random
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import recordio as trio

LOSS_RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITER_KW = dict(data_shape=(3, 24, 24), batch_size=5, resize=28,
               rand_crop=True, rand_mirror=True, shuffle=True, mean_r=123.68,
               mean_g=116.779, mean_b=103.939, std_r=58.393, std_g=57.12,
               std_b=57.375, seed=3)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ref():
    import mxnet_tpu as mx

    return mx


def _images(n, seed=0, lo=20, hi=48):
    rs = onp.random.RandomState(seed)
    return [rs.randint(0, 256, (rs.randint(lo, hi), rs.randint(lo, hi), 3))
            .astype("uint8") for _ in range(n)]


def _pack(rio, prefix, images, labels=None, fmt=".jpg"):
    rec = rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, img in enumerate(images):
        label = float(i % 5) if labels is None else labels[i]
        rec.write_idx(i, rio.pack_img(rio.IRHeader(0, label, i), img,
                                      quality=95, img_fmt=fmt))
    rec.close()
    return prefix + ".rec"


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    """13 JPEG records of 20-47 px a side (the last batch of 5 is short)."""
    return _pack(trio, str(tmp_path_factory.mktemp("rec") / "data"),
                 _images(13))


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    onp.testing.assert_array_equal(a, b)


# -- recordio ---------------------------------------------------------------------
def test_record_files_interchange_byte_for_byte(tmp_path):
    from mxnet_tpu import recordio as jrio

    images = _images(6, seed=1)
    files = {}
    for tag, rio in (("port", trio), ("ref", jrio)):
        prefix = str(tmp_path / tag)
        _pack(rio, prefix, images, labels=[[i, 0.5, 2.0] for i in range(6)])
        files[tag] = prefix
        for ext in (".rec", ".idx"):
            files[tag + ext] = open(prefix + ext, "rb").read()
    assert files["port.rec"] == files["ref.rec"]
    assert files["port.idx"] == files["ref.idx"]
    # each package reads the other's file, by key and in sequence
    for reader, writer in ((trio, "ref"), (jrio, "port")):
        rec = reader.MXIndexedRecordIO(files[writer] + ".idx",
                                       files[writer] + ".rec", "r")
        assert rec.keys == list(range(6))
        for k in reversed(rec.keys):
            header, img = reader.unpack_img(rec.read_idx(k))
            assert header.flag == 3 and header.id == k
            onp.testing.assert_array_equal(header.label, [k, 0.5, 2.0])
        seq = reader.MXRecordIO(files[writer] + ".rec", "r")
        n = 0
        while seq.read() is not None:
            n += 1
        assert n == 6
        seq.close()
        rec.close()


def test_pack_img_png_and_list_labels_roundtrip_as_the_reference():
    from mxnet_tpu import recordio as jrio

    img = _images(1, seed=2)[0]
    for header in (trio.IRHeader(0, 7.0, 3, 1),
                   trio.IRHeader(0, onp.array([1.5, 2.5]), 4)):
        jh = jrio.IRHeader(header.flag, header.label, header.id, header.id2)
        s = trio.pack_img(header, img, img_fmt=".png")
        assert s == jrio.pack_img(jh, img, img_fmt=".png")
        (th, timg_), (rh, rimg) = trio.unpack_img(s), jrio.unpack_img(s)
        onp.testing.assert_array_equal(timg_, img)
        onp.testing.assert_array_equal(timg_, rimg)
        assert (th.flag, th.id, th.id2) == (rh.flag, rh.id, rh.id2)
        onp.testing.assert_array_equal(th.label, rh.label)
    with pytest.raises(MXNetError, match="invalid flag"):
        trio.MXRecordIO("x.rec", "a")


def test_a_failed_native_build_raises_with_the_compiler_output(tmp_path):
    from mxnet_tpu_torch.io._cbuild import NativeLib

    src = tmp_path / "broken.cc"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(MXNetError, match="(?s)broken.*error"):
        NativeLib(str(src), "test library", lambda lib: None).get()
    with pytest.raises(MXNetError, match="missing"):
        NativeLib(str(tmp_path / "none.cc"), "test library",
                  lambda lib: None).get()


# -- mx.image ---------------------------------------------------------------------
def _augs(pkg):
    img = pkg.image
    eigval = onp.array([55.46, 4.794, 1.148])
    eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.814],
                        [-0.5836, -0.6948, 0.4203]])
    return {
        "ResizeAug": img.ResizeAug(20), "ForceResizeAug": img.ForceResizeAug(
            (17, 23)), "RandomCropAug": img.RandomCropAug((15, 12)),
        "CenterCropAug": img.CenterCropAug((15, 12)),
        "HorizontalFlipAug": img.HorizontalFlipAug(0.5),
        "CastAug": img.CastAug(), "ColorNormalizeAug": img.ColorNormalizeAug(
            onp.array([123.68, 116.28, 103.53]), onp.array([58.4, 57.1, 57.4])),
        "BrightnessJitterAug": img.BrightnessJitterAug(0.4),
        "ContrastJitterAug": img.ContrastJitterAug(0.4),
        "SaturationJitterAug": img.SaturationJitterAug(0.4),
        "HueJitterAug": img.HueJitterAug(0.4),
        "ColorJitterAug": img.ColorJitterAug(0.3, 0.3, 0.3),
        "LightingAug": img.LightingAug(0.1, eigval, eigvec),
        "RandomGrayAug": img.RandomGrayAug(0.5),
        "RandomSizedCropAug": img.RandomSizedCropAug((14, 14)),
        "SequentialAug": img.SequentialAug([img.ResizeAug(30),
                                            img.RandomCropAug((20, 20))])}


@pytest.mark.parametrize("name", list(_augs(tmx)))
def test_augmenters_match_the_reference_after_one_seed(name):
    mx = _ref()
    src = _images(1, seed=3, lo=30, hi=40)[0]
    for seed in (0, 1, 2):
        outs = []
        for pkg in (mx, tmx):
            pkg.random.seed(seed)
            aug = _augs(pkg)[name]
            x = src.astype("float32") if "Jitter" in name or name in (
                "LightingAug", "RandomGrayAug") else src
            outs.append(aug(x))
        _same(*outs)


@pytest.mark.parametrize("det", [False, True])
def test_create_augmenter_pipelines_match_the_reference(det):
    mx = _ref()
    src = _images(1, seed=4, lo=40, hi=60)[0]
    label = onp.array([[1, 0.1, 0.2, 0.5, 0.6], [3, 0.4, 0.3, 0.9, 0.95],
                       [-1, -1, -1, -1, -1]], "float32")
    kw = dict(resize=36, rand_mirror=True, mean=True, std=True,
              brightness=0.3, contrast=0.3, saturation=0.3, pca_noise=0.1)
    kw.update(dict(rand_crop=0.7, rand_pad=0.6, hue=0.2) if det else
              dict(rand_crop=True, rand_gray=0.3))
    for seed in range(4):
        outs = []
        for pkg in (mx, tmx):
            pkg.random.seed(seed)
            make = pkg.image.CreateDetAugmenter if det else \
                pkg.image.CreateAugmenter
            augs = make((3, 24, 24), **kw)
            x, lab = src, label
            for aug in augs:
                x, lab = aug(x, lab) if det else (aug(x), lab)
            outs.append((x, lab))
        _same(outs[0][0], outs[1][0])
        _same(outs[0][1], outs[1][1])


def test_image_functions_match_the_reference(tmp_path):
    import io as pyio

    from PIL import Image

    mx = _ref()
    src = _images(1, seed=5, lo=30, hi=50)[0]
    chw = (src.transpose(2, 0, 1) / 255.0).astype("float32")
    buf = pyio.BytesIO()
    Image.fromarray(src).save(buf, format="PNG")
    (tmp_path / "a.png").write_bytes(buf.getvalue())
    cases = [
        lambda m: m.image.imresize(src, 13, 21),
        lambda m: m.image.resize_short(src, 17),
        lambda m: m.image.fixed_crop(src, 2, 3, 10, 12, size=(8, 9)),
        lambda m: m.image.random_crop(src, (11, 7))[0],
        lambda m: m.image.center_crop(src, (11, 7))[0],
        lambda m: m.image.color_normalize(src, onp.array([1.0, 2, 3]),
                                          onp.array([2.0, 3, 4])),
        lambda m: onp.asarray(m.image.scale_down((20, 30), (25, 40))),
        lambda m: m.image.copyMakeBorder(src, 1, 2, 3, 4, border_type=1),
        lambda m: m.image.copyMakeBorder(src, 1, 2, 3, 4, value=7),
        lambda m: m.image.random_size_crop(src, (9, 9), (0.3, 1.0),
                                           (0.75, 1.33))[0],
        lambda m: m.image.imrotate(chw, 30.0, zoom_in=True),
        lambda m: m.image.random_rotate(onp.stack([chw, chw]), (-40, 40)),
        lambda m: m.image.imdecode(buf.getvalue()),
        lambda m: m.image.imread(str(tmp_path / "a.png")),
    ]
    for i, case in enumerate(cases):
        outs = []
        for pkg in (mx, tmx):
            pkg.random.seed(i)
            outs.append(case(pkg))
        _same(*outs)
    got = tmx.image.imdecode(buf.getvalue())
    assert got.context.device_type == "cpu"
    onp.testing.assert_array_equal(got.asnumpy(), src)
    with pytest.raises(MXNetError, match="zoom_in and zoom_out"):
        tmx.image.imrotate(chw, 10.0, zoom_in=True, zoom_out=True)


def test_image_iter_matches_the_reference(rec_file, tmp_path):
    mx = _ref()
    paths = []
    for i, img in enumerate(_images(4, seed=6)):
        path = tmp_path / f"{i}.png"
        from PIL import Image

        Image.fromarray(img).save(str(path))
        paths.append(f"{i}\t{i % 3}\t{path.name}\n")
    (tmp_path / "list.lst").write_text("".join(paths))
    for kw in (dict(path_imgrec=rec_file),
               dict(path_imglist=str(tmp_path / "list.lst"),
                    path_root=str(tmp_path) + os.sep)):
        runs = []
        for pkg in (mx, tmx):
            pkg.random.seed(1)
            onp.random.seed(2)
            it = pkg.image.ImageIter(4, (3, 16, 16), resize=20,
                                     rand_crop=True, rand_mirror=True,
                                     shuffle=True, **kw)
            runs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                         for b in it])
        assert len(runs[0]) == len(runs[1]) >= 1
        for (d0, l0, p0), (d1, l1, p1) in zip(*runs):
            _same(d0, d1)
            _same(l0, l1)
            assert p0 == p1


# -- ImageRecordIter ----------------------------------------------------------------
@pytest.mark.parametrize("threads", [1, 4])
def test_image_record_iter_matches_the_reference_at_any_thread_count(
        rec_file, threads):
    mx = _ref()
    want = mx.io.ImageRecordIter(rec_file, preprocess_threads=1, **ITER_KW)
    got = tmx.io.ImageRecordIter(rec_file, preprocess_threads=threads,
                                 **ITER_KW)
    assert got.num_records == want.num_records == 13
    for _ in range(2):
        n = 0
        for wb, gb in zip(want, got):
            _same(wb.data[0], gb.data[0])
            _same(wb.label[0], gb.label[0])
            assert wb.pad == gb.pad
            n += 1
        assert n == 3
        with pytest.raises(StopIteration):
            next(got)
        want.reset()
        got.reset()


def test_image_record_iter_keywords_and_short_batches(rec_file):
    mx = _ref()
    kw = dict(ITER_KW, round_batch=False, rand_crop=False, resize=-1,
              shuffle=False, data_shape=(3, 40, 40))
    with pytest.warns(UserWarning, match="no_such_option"):
        got = list(tmx.io.ImageRecordIter(rec_file, no_such_option=1, **kw))
    want = list(mx.io.ImageRecordIter(rec_file, preprocess_threads=1, **kw))
    assert [b.data[0].shape for b in got] == [(5, 3, 40, 40)] * 2 + \
        [(3, 3, 40, 40)]
    for wb, gb in zip(want, got):
        _same(wb.data[0], gb.data[0])
        assert gb.pad == 0
    with pytest.raises(MXNetError, match="cannot open"):
        tmx.io.ImageRecordIter(rec_file + ".missing", (3, 8, 8), 2)


def _threads():
    """Threads of this process, the native ones included."""
    return len(os.listdir("/proc/self/task"))


def test_dropped_iterators_leave_no_thread_behind(rec_file):
    import gc

    first = tmx.io.ImageRecordIter(rec_file, preprocess_threads=2, **{
        k: v for k, v in ITER_KW.items() if k != "seed"})
    next(first)
    del first
    gc.collect()
    before = _threads()
    for i in range(50):
        it = tmx.io.ImageRecordIter(rec_file, preprocess_threads=2, **ITER_KW)
        if i % 2:
            next(it)
        del it
    gc.collect()
    assert _threads() == before


# -- the RecordIO datasets ---------------------------------------------------------
def test_record_datasets_match_the_reference(rec_file, tmp_path):
    mx = _ref()
    from mxnet_tpu_torch.gluon import data as tdata
    from mxnet_tpu_torch.gluon.data import vision

    raw_t, raw_j = tdata.RecordFileDataset(rec_file), \
        mx.gluon.data.RecordFileDataset(rec_file)
    assert len(raw_t) == len(raw_j) == 13
    assert all(raw_t[i] == raw_j[i] for i in range(13))
    back = pickle.loads(pickle.dumps(raw_t))
    assert raw_t._record is None and back._record is None
    assert back[4] == raw_j[4]
    recs = (vision.ImageRecordDataset(rec_file),
            mx.gluon.data.vision.ImageRecordDataset(rec_file))
    for i in (0, 7, 12):
        (ti, tl), (ji, jl) = recs[0][i], recs[1][i]
        _same(ti, ji)
        assert tl == jl
    lst = []
    for i, img in enumerate(_images(3, seed=7)):
        from PIL import Image

        Image.fromarray(img).save(str(tmp_path / f"{i}.png"))
        lst.append(f"{i}\t{i}\t{2 * i}\t{i}.png\n")
    (tmp_path / "a.lst").write_text("".join(lst))
    for imglist in ("a.lst", [[1.0, "0.png"], [2.0, "1.png"]],
                    [[1.0, 3.0, 5.0, "2.png"]]):
        got = vision.ImageListDataset(str(tmp_path), imglist)
        want = mx.gluon.data.vision.ImageListDataset(str(tmp_path), imglist)
        assert len(got) == len(want)
        for i in range(len(got)):
            (ti, tl), (ji, jl) = got[i], want[i]
            _same(ti, ji)
            onp.testing.assert_array_equal(tl, jl)
    with pytest.raises(MXNetError, match="index sidecar"):
        tdata.RecordFileDataset(str(tmp_path / "no.rec"))


# -- gluon.contrib.data.vision -------------------------------------------------------
def _bbox_blocks(pkg):
    v = pkg.gluon.contrib.data.vision
    return {"flip": v.ImageBboxRandomFlipLeftRight(0.5),
            "crop": v.ImageBboxCrop((3, 4, 20, 18)),
            "crop_constraints": v.ImageBboxRandomCropWithConstraints(p=0.9),
            "expand": v.ImageBboxRandomExpand(p=0.9, fill=(1, 2, 3)),
            "resize": v.ImageBboxResize(17, 13)}


def _boxes(seed, n):
    rs = onp.random.RandomState(seed)
    xy = rs.uniform(0, 25, (n, 2))
    wh = rs.uniform(3, 15, (n, 2))
    return onp.concatenate([xy, xy + wh, rs.randint(0, 5, (n, 1)),
                            rs.rand(n, 1)], axis=1).astype("float32")


@pytest.mark.parametrize("name", list(_bbox_blocks(tmx)))
def test_bbox_blocks_match_the_reference_after_one_seed(name):
    mx = _ref()
    img = _images(1, seed=8, lo=36, hi=44)[0]
    for seed in range(4):
        bbox = _boxes(seed, 1 + seed)
        outs = []
        for pkg in (mx, tmx):
            random.seed(seed)
            outs.append(_bbox_blocks(pkg)[name](pkg.np.array(img),
                                                pkg.np.array(bbox)))
        _same(outs[0][0], outs[1][0])
        _same(outs[0][1], outs[1][1])


def test_bbox_loader_pads_batches_like_the_reference():
    mx = _ref()
    imgs = _images(7, seed=9, lo=32, hi=33)
    boxes = [_boxes(i, 1 + i % 4) for i in range(7)]

    def loader(pkg):
        v = pkg.gluon.contrib.data.vision
        ds = pkg.gluon.data.ArrayDataset(imgs, boxes)
        return v.ImageBboxDataLoader(
            ds, 3, bbox_transforms=[v.ImageBboxRandomFlipLeftRight(0.5),
                                    v.ImageBboxResize(20, 20)])

    runs = []
    for pkg in (mx, tmx):
        random.seed(4)
        runs.append([(x.asnumpy(), y.asnumpy()) for x, y in loader(pkg)])
    assert [y.shape for _, y in runs[1]] == [(3, 3, 6), (3, 4, 6), (1, 3, 6)]
    for (x0, y0), (x1, y1) in zip(*runs):
        _same(x0, x1)
        _same(y0, y1)
    # ImageDataLoader: the classification loader with a per-sample transform
    labels = onp.arange(7, dtype="float32")
    runs = []
    for pkg in (mx, tmx):
        ds = pkg.gluon.data.ArrayDataset(imgs, labels)
        runs.append([(x.asnumpy(), y.asnumpy()) for x, y in
                     pkg.gluon.contrib.data.vision.ImageDataLoader(
                         ds, 4, transform_fn=lambda a: a[::2, ::2])])
    for (x0, y0), (x1, y1) in zip(*runs):
        _same(x0, x1)
        _same(y0, y1)


def test_gluon_contrib_estimator_is_a_later_item():
    with pytest.raises(MXNetError, match=r"A10 \(5\)"):
        tmx.gluon.contrib.estimator
    assert tmx.gluon.contrib.data.vision.ImageBboxDataLoader


# -- tools/port_im2rec.py -------------------------------------------------------------
def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_im2rec_writes_the_reference_tools_files(tmp_path, monkeypatch):
    from PIL import Image

    root = tmp_path / "images"
    for c, cls in enumerate(("cat", "dog")):
        (root / cls / "sub").mkdir(parents=True)
        for i, img in enumerate(_images(3, seed=10 + c)):
            Image.fromarray(img).save(str(root / cls / f"{i}.jpg"))
        Image.fromarray(_images(1, seed=20 + c)[0]).save(
            str(root / cls / "sub" / "n.png"))
    out = {}
    for name in ("im2rec", "port_im2rec"):
        prefix = str(tmp_path / name)
        tool = _tool(name)
        monkeypatch.setattr(sys, "argv", [name, prefix, str(root),
                                          "--recursive", "--quality", "90"])
        tool.main()
        out[name] = [open(prefix + ext, "rb").read()
                     for ext in (".lst", ".rec", ".idx")]
    assert out["im2rec"] == out["port_im2rec"]
    assert out["im2rec"][0].count(b"\n") == 8
    assert "mxnet_tpu." not in open(os.path.join(
        ROOT, "tools", "port_im2rec.py")).read().replace("mxnet_tpu_torch",
                                                         "")


# -- the slice as a whole --------------------------------------------------------------
def _resnet(pkg):
    res = pkg.gluon.model_zoo.vision.resnet
    return res.ResNetV1(res.BasicBlockV1, [1, 1], [8, 8, 16], classes=5,
                        thumbnail=True)


def test_resnet_trains_from_a_rec_like_the_reference(rec_file, tmp_path):
    """Two SGD steps of a two-stage ResNet v1 on 16 x 16 crops that each
    package's ``ImageRecordIter`` reads; the port loads the reference's
    ``.params``."""
    mx = _ref()
    kw = dict(ITER_KW, data_shape=(3, 16, 16), batch_size=4, resize=20)
    net = _resnet(mx)
    net.initialize()
    with mx.autograd.pause():
        net(mx.np.zeros((1, 3, 16, 16)))
    path = str(tmp_path / "net.params")
    net.save_parameters(path)
    tnet = _resnet(tmx)
    tnet.load_parameters(path)
    losses = []
    # the reference's draws race between its threads: it reads with one
    for pkg, model, threads in ((mx, net, 1), (tmx, tnet, 4)):
        it = pkg.io.ImageRecordIter(rec_file, preprocess_threads=threads,
                                    **kw)
        trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                    {"learning_rate": 0.05})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        run = []
        for _ in range(2):
            batch = next(it)
            with pkg.autograd.record():
                loss = loss_fn(model(batch.data[0]), batch.label[0])
            loss.backward()
            trainer.step(kw["batch_size"])
            run.append(float(loss.mean().asnumpy()))
        losses.append(run)
    assert all(onp.isfinite(losses[1]))
    for want, got in zip(*losses):
        assert abs(got - want) <= LOSS_RTOL * abs(want), losses


# -- on the card ------------------------------------------------------------------------
@pytest.mark.cuda
def test_image_record_iter_lands_the_hosts_batch_on_the_card(cuda, rec_file):
    host = list(tmx.io.ImageRecordIter(rec_file, **ITER_KW))
    with tmx.gpu():
        card = list(tmx.io.ImageRecordIter(rec_file, preprocess_threads=4,
                                           **ITER_KW))
    assert len(host) == len(card) == 3
    for h, c in zip(host, card):
        assert c.data[0]._data.device.type == "cuda"
        _same(h.data[0], c.data[0])
        _same(h.label[0], c.label[0])
