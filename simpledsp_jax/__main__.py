from simpledsp_jax.cli import main
from simpledsp_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()
raise SystemExit(main())
