"""Compare the SASS of csrc/blend.cu in another tree with this one's.

    git archive <commit> gsm_renderer_tpu_torch | tar -x -C local/ab/parent
    python3 scratch/sass_ab.py local/ab/parent

builds both trees' blend.cu with the port's nvcc flags (on a machine with
the CUDA toolkit) into local/sass_ab/ and compares `cuobjdump -sass`
kernel by kernel, keyed by chip_smoke.kernel_label (the mangled names of
the anonymous namespace differ between two source paths); immediates are
dropped, since branch targets are absolute addresses.  Prints how many
kernels the two builds share and how many of those are identical.
"""
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import kernel_label  # noqa: E402
from gsm_renderer_tpu_torch import _native  # noqa: E402


def build(src: Path, so: Path, nvcc: str) -> subprocess.Popen:
    log = open(so.with_suffix(".log"), "w")
    return subprocess.Popen([nvcc, *_native.NVCC_FLAGS, "-o", str(so),
                             str(src / "blend.cu")], stdout=log,
                            stderr=subprocess.STDOUT)


def functions(so: Path, cuobjdump: str) -> dict:
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    res = {}
    for chunk in text.split("Function : ")[1:]:
        res[kernel_label(chunk.split()[0])] = [
            re.sub(r"0x[0-9a-f]+", "0x", m.group(1).strip())
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", chunk)]
    return res


def main() -> int:
    root = Path(__file__).resolve().parent.parent
    other = Path(sys.argv[1]) / "gsm_renderer_tpu_torch" / "csrc"
    here = root / "gsm_renderer_tpu_torch" / "csrc"
    out = Path("local/sass_ab")
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _native._nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    builds = {"other": build(other, out / "other.so", nvcc),
              "this": build(here, out / "this.so", nvcc)}
    for name, proc in builds.items():
        if proc.wait() != 0:
            print(name, "build failed:",
                  (out / f"{name}.log").read_text()[-3000:])
            return 1
    a = functions(out / "other.so", cuobjdump)
    b = functions(out / "this.so", cuobjdump)
    common = sorted(set(a) & set(b))
    differ = [n for n in common if a[n] != b[n]]
    print(f"sass_ab: {len(common)} kernels in common, "
          f"{len(common) - len(differ)} identical, {len(differ)} differ; "
          f"only in the other tree {len(set(a) - set(b))}, only in this one "
          f"{len(set(b) - set(a))}")
    for n in differ:
        print("differs:", n, len(a[n]), "->", len(b[n]), "instructions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
