.PHONY: native test bench clean chip-smoke

# The main path on one GPU, every phase checked against a CPU reference
# (README "Running on the GPU"); exits non-zero without a GPU.
chip-smoke:
	python chip_smoke.py

# Native CSV extension, built into native/ (gitignored) where
# scythe_tpu.io looks for it.
native:
	cd native && python setup.py -q build_ext --inplace

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

bench:
	python bench.py

clean:
	rm -rf native/build native/*.so
