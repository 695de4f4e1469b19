"""The training-loop timing script's recipe reader, on the CPU."""

from healthivert_tpu_torch.experiments import train_timing


def test_read_recipe_gives_the_shipped_options():
    opt = train_timing.read_recipe()
    assert train_timing.RECIPE.is_file()
    assert (opt.batch_size, opt.compute_dtype, opt.netD) == (32, "bfloat16", "basic")
    assert isinstance(opt.lr, float) and isinstance(opt.seed, int)


def test_read_recipe_parses_values_and_default_notes(tmp_path):
    path = tmp_path / "train_opt.txt"
    path.write_text("----------------- Options ---------------\n"
                    "  batch_size: 4   [default: 1]\n  lr: 0.0002\n  name: run\n"
                    "  no_flip: True\n  load_npz: None\n")
    opt = train_timing.read_recipe(path)
    assert (opt.batch_size, opt.lr, opt.name, opt.no_flip, opt.load_npz) == (
        4, 0.0002, "run", True, None)
