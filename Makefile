# fastlanes-tpu developer workflow (the reference's CI surface, ci.yml:49-56)

.PHONY: test test-fast lint native bench smoke clean

test:
	python -m pytest tests/ -q

lint:
	python tools/lint.py

test-fast:
	python -m pytest tests/ -q -x -k "not sweep and not u64"

native:
	python -c "from fastlanes_tpu import native; print(native.build(force=True))"

bench:
	python bench.py

smoke:
	python chip_smoke.py

clean:
	rm -f fastlanes_tpu/native/libfastlanes_native.so
	find . -name __pycache__ -type d -exec rm -rf {} +
