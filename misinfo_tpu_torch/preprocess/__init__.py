"""Host-side preprocessing. The names below load on first use: the
transcript worker imports ``preprocess/audio.py`` alone and must stay free
of everything but numpy and the standard library."""

_EXPORTS = {
    "RobertaTokenizer": "tokenizer", "ClipTokenizer": "tokenizer",
    "HashTokenizer": "tokenizer",
    "load_image_rgb": "image", "image_to_array": "image",
    "CLIP_MEAN": "image", "CLIP_STD": "image", "IMAGENET_MEAN": "image",
    "IMAGENET_STD": "image",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(
            f"misinfo_tpu_torch.preprocess.{_EXPORTS[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
