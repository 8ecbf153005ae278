"""Declarative config-schema validation with defaults injection.

Counterpart of the reference's jsonschema pipeline
(tardis/io/configuration/config_validator.py:32-201 and the
schemas under io/configuration/schemas/*.yml): every config section is
checked against a typed schema — unknown keys raise (with a did-you-mean
suggestion), enums are enforced, quantity strings are checked for the right
*physical dimension*, and schema defaults are injected before parsing.

The schema below mirrors the reference's key set and defaults for the
sections this framework implements (base/model/plasma/montecarlo/spectrum/
debug + csvy), expressed as plain Python instead of Draft-7 JSON schema.
"""

from __future__ import annotations

import difflib
import math

from tardis_torch.config.reader import parse_quantity, unit_dimension

# physical dimensions (L, M, T, Theta)
DIMS = {
    "length": (1, 0, 0, 0),
    "time": (0, 0, 1, 0),
    "velocity": (1, 0, -1, 0),
    "density": (-3, 1, 0, 0),
    "power": (2, 1, -3, 0),
    "temperature": (0, 0, 0, 1),
    "dimensionless": (0, 0, 0, 0),
}


class ConfigurationError(ValueError):
    """Invalid TARDIS configuration (mirrors reference jsonschema errors)."""


def q(dim, default=None, required=False):
    return {"type": "quantity", "dim": dim, "default": default,
            "required": required}


def num(default=None, required=False, enum=None):
    return {"type": "number", "default": default, "required": required,
            "enum": enum}


def boolean(default=False):
    return {"type": "bool", "default": default}


def string(default=None, enum=None, required=False):
    return {"type": "string", "default": default, "enum": enum,
            "required": required}


def obj(properties, default="{}", additional=False, pattern=None,
        required=False):
    return {
        "type": "object",
        "properties": properties,
        "default": default,
        "additional": additional,
        "pattern": pattern,  # validator fn for non-declared keys
        "required": required,
    }


def lst(default=None):
    return {"type": "list", "default": default if default is not None else []}


def anyval(default=None):
    return {"type": "any", "default": default}


_ELEMENT = str.isalpha  # element-symbol-ish key (O, Mg, Ni56 handled below)


def _element_key(k):
    return k[:1].isupper() and all(c.isalnum() for c in k)


# per-quantity convergence sub-spec (montecarlo_definitions.yml)
def _conv_sub():
    return obj(
        {
            "damping_constant": num(),
            "threshold": num(),
            "type": string(),
        },
        default=None,
    )


CONVERGENCE_SCHEMA = obj(
    {
        "type": string(default="damped",
                       enum=["damped", "adaptive_damped", "custom"]),
        "stop_if_converged": boolean(False),
        "fraction": num(0.8),
        "hold_iterations": num(3),
        "damping_constant": num(None),
        "threshold": num(0.05),
        "lock_t_inner_cycles": num(1),
        "t_inner_update_exponent": num(-0.5),
        "t_inner": _conv_sub(),
        "t_rad": _conv_sub(),
        "w": _conv_sub(),
    }
)

DENSITY_SCHEMA = obj(
    {
        "type": string(
            required=True,
            enum=["branch85_w7", "exponential", "power_law", "uniform"],
        ),
        "w7_time_0": q("time"),
        "w7_rho_0": q("density"),
        "w7_v_0": q("velocity"),
        "time_0": q("time"),
        "rho_0": q("density"),
        "v_0": q("velocity"),
        "value": q("density"),
        "exponent": num(),
    },
    default={"type": "branch85_w7"},
)

STRUCTURE_SCHEMA = obj(
    {
        "type": string(default="specific", enum=["specific", "file"]),
        "velocity": obj(
            {
                "start": q("velocity", required=True),
                "stop": q("velocity", required=True),
                "num": num(required=True),
            },
            default=None,
        ),
        "density": DENSITY_SCHEMA,
        "filename": string(),
        "filetype": string(),
        "v_inner_boundary": q("velocity"),
        "v_outer_boundary": q("velocity"),
    }
)

ABUNDANCES_SCHEMA = obj(
    {
        "type": string(default="uniform", enum=["uniform", "file"]),
        "filename": string(),
        "filetype": string(),
        "model_isotope_time_0": q("time"),
    },
    pattern=_element_key,  # element symbols / isotopes as extra keys
)

PLASMA_SCHEMA = obj(
    {
        "ionization": string(default="lte", enum=["lte", "nebular"]),
        "excitation": string(default="lte", enum=["lte", "dilute-lte"]),
        "radiative_rates_type": string(
            default="dilute-blackbody",
            enum=["dilute-blackbody", "detailed", "blackbody"],
        ),
        "line_interaction_type": string(
            default="scatter", enum=["scatter", "downbranch", "macroatom"]
        ),
        "disable_electron_scattering": boolean(False),
        "disable_line_scattering": boolean(False),
        "initial_t_inner": q("temperature", default="-1 K"),
        "initial_t_rad": q("temperature", default="-1 K"),
        "link_t_rad_t_electron": num(0.9),
        "w_epsilon": num(1e-10),
        "nlte": obj(
            {
                "species": lst(),
                "coronal_approximation": boolean(False),
                "classical_nebular": boolean(False),
            }
        ),
        "continuum_interaction": obj(
            {
                "species": lst(),
                "enable_adiabatic_cooling": boolean(False),
                "enable_two_photon_decay": boolean(False),
            }
        ),
        "helium_treatment": string(
            default="none", enum=["none", "recomb-nlte", "numerical-nlte"]
        ),
        "heating_rate_data_file": string(),
    }
)

MONTECARLO_SCHEMA = obj(
    {
        "seed": num(23111963),
        "no_of_packets": num(required=True),
        "iterations": num(required=True),
        "nthreads": num(1),
        "last_no_of_packets": num(-1),
        "no_of_virtual_packets": num(0),
        "enable_full_relativity": boolean(False),
        "enable_nonhomologous_expansion": boolean(False),
        "enable_reflective_inner_boundary": boolean(False),
        "inner_boundary_albedo": num(0.0),
        "tracking": obj(
            {
                "track_rpacket": boolean(False),
                "track_last_interaction": boolean(True),
                "initial_array_length": num(10),
            }
        ),
        "virtual_spectrum_spawn_range": obj(
            {
                "start": q("length", default="1 angstrom"),
                "end": q("length", default="inf angstrom"),
            }
        ),
        "convergence_strategy": CONVERGENCE_SCHEMA,
        "debug_packets": boolean(False),
        "logger_buffer": num(1),
        # TPU-native extensions
        "batch_size": num(65536),
        "use_macro_chain": anyval("auto"),
        "packet_source": string(
            default="auto",
            enum=["auto", "simple", "weighted", "relativistic"],
        ),
    },
    required=True,
)

SPECTRUM_SCHEMA = obj(
    {
        "start": q("length", required=True),
        "stop": q("length", required=True),
        "num": num(required=True),
        "method": string(default="real",
                         enum=["real", "virtual", "integrated"]),
        "integrated": obj(
            {
                "points": num(1000),
                "interpolate_shells": num(0),
                "compute": string(default="jax"),
            }
        ),
        "virtual": obj(
            {
                "tau_russian": num(10.0),
                "survival_probability": num(0.0),
                "enable_biasing": boolean(False),
                "virtual_packet_logging": boolean(False),
            }
        ),
    },
    required=True,
)

BASE_SCHEMA = {
    "tardis_config_version": string(default="v1.0"),
    "supernova": obj(
        {
            "luminosity_requested": q("power", required=True),
            "time_explosion": q("time", required=True),
            "distance": q("length"),
            "luminosity_wavelength_start": q("length", default="0 angstrom"),
            "luminosity_wavelength_end": q(
                "length", default="inf angstrom"
            ),
        },
        required=True,
    ),
    "atom_data": string(default="synthetic"),
    "csvy_model": string(),
    "model": obj(
        {"structure": STRUCTURE_SCHEMA, "abundances": ABUNDANCES_SCHEMA}
    ),
    "plasma": PLASMA_SCHEMA,
    "montecarlo": MONTECARLO_SCHEMA,
    "spectrum": SPECTRUM_SCHEMA,
    "debug": obj(
        {
            "log_level": string(),
            "specific_log_level": boolean(False),
            "debug_packets": boolean(False),
        }
    ),
}


def _err(path, msg):
    raise ConfigurationError(f"config{path}: {msg}")


def _check_quantity(value, spec, path):
    if value is None:
        return
    if isinstance(value, (int, float)):
        return  # bare number: interpreted as cgs downstream
    parts = str(value).split(None, 1)
    try:
        float(parts[0])
    except ValueError:
        _err(path, f"cannot parse quantity {value!r}")
    if len(parts) == 1:
        return
    try:
        dims = unit_dimension(parts[1])
    except ValueError as exc:
        _err(path, str(exc))
    want = DIMS[spec["dim"]]
    if tuple(dims) != tuple(float(x) for x in want):
        _err(
            path,
            f"expected a {spec['dim']} quantity, got {value!r} "
            f"(dimension {dims})",
        )
    try:
        parse_quantity(value)
    except ValueError as exc:
        _err(path, str(exc))


def _validate_node(value, spec, path):
    """Validate `value` against `spec`; returns value with defaults filled."""
    t = spec["type"]
    if value is None:
        return value
    if t == "quantity":
        _check_quantity(value, spec, path)
        return value
    if t == "number":
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            try:
                value = float(value)
            except (TypeError, ValueError):
                _err(path, f"expected a number, got {value!r}")
        if spec.get("enum") and value not in spec["enum"]:
            _err(path, f"{value!r} not one of {spec['enum']}")
        return value
    if t == "bool":
        if not isinstance(value, bool):
            _err(path, f"expected a boolean, got {value!r}")
        return value
    if t == "string":
        if not isinstance(value, str):
            _err(path, f"expected a string, got {value!r}")
        if spec.get("enum") and value not in spec["enum"]:
            _err(path, f"{value!r} not one of {spec['enum']}")
        return value
    if t == "list":
        if not isinstance(value, (list, tuple)):
            _err(path, f"expected a list, got {value!r}")
        return list(value)
    if t == "any":
        return value
    if t == "object":
        if not isinstance(value, dict):
            _err(path, f"expected a mapping, got {value!r}")
        return _validate_object(value, spec, path)
    raise AssertionError(f"unknown spec type {t}")


def _validate_object(value, spec, path):
    props = spec["properties"]
    out = {}
    for k, v in value.items():
        if k in props:
            out[k] = _validate_node(v, props[k], f"{path}.{k}")
        elif spec.get("pattern") and spec["pattern"](k):
            out[k] = v
        elif spec.get("additional"):
            out[k] = v
        else:
            hint = difflib.get_close_matches(k, props.keys(), n=1)
            suggestion = f"; did you mean {hint[0]!r}?" if hint else ""
            _err(path, f"unknown key {k!r}{suggestion}")
    # required + defaults
    for k, sub in props.items():
        if k in out:
            continue
        if sub.get("required"):
            _err(path, f"missing required key {k!r}")
        d = sub.get("default")
        if sub["type"] == "object":
            if d == "{}":
                out[k] = _validate_object({}, sub, f"{path}.{k}")
            elif isinstance(d, dict):
                out[k] = _validate_object(dict(d), sub, f"{path}.{k}")
            elif d is not None:
                out[k] = d
        elif d is not None:
            out[k] = d
    return out


def validate_schema(raw: dict) -> dict:
    """Validate a raw config dict against the TARDIS schema.

    Raises ConfigurationError on unknown keys (with suggestions), enum
    violations, wrong quantity dimensions, or missing required keys; returns
    a new dict with schema defaults injected (quantities still unparsed).
    """
    if not isinstance(raw, dict):
        raise ConfigurationError("config root must be a mapping")
    out = {}
    for k, v in raw.items():
        if k not in BASE_SCHEMA:
            hint = difflib.get_close_matches(k, BASE_SCHEMA.keys(), n=1)
            suggestion = f"; did you mean {hint[0]!r}?" if hint else ""
            raise ConfigurationError(f"config: unknown section {k!r}{suggestion}")
        out[k] = _validate_node(v, BASE_SCHEMA[k], f".{k}")
    for k, spec in BASE_SCHEMA.items():
        if k in out:
            continue
        if spec.get("required"):
            if k == "model" and "csvy_model" in out:
                continue
            raise ConfigurationError(f"config: missing required section {k!r}")
        if spec["type"] == "object" and spec.get("default") == "{}":
            continue  # optional sections stay absent
        if spec.get("default") is not None and spec["type"] != "object":
            out[k] = spec["default"]
    # model is required unless a csvy_model is given
    if "model" not in out and "csvy_model" not in out:
        raise ConfigurationError(
            "config: either 'model' or 'csvy_model' must be provided"
        )
    if "supernova" not in out:
        raise ConfigurationError("config: missing required section 'supernova'")
    return out
