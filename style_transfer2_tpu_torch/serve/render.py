"""Jinja2 template rendering for aiohttp (standalone — no aiohttp_jinja2):
a copy of style_transfer2_tpu/serve/render.py that serves the templates and
static files under this package's own directory."""

from pathlib import Path

import jinja2
from aiohttp import web

TEMPLATES_PATH = Path(__file__).parent / 'templates'
STATIC_PATH = Path(__file__).parent / 'static'

_env = jinja2.Environment(
    loader=jinja2.FileSystemLoader(str(TEMPLATES_PATH)),
    autoescape=jinja2.select_autoescape(['html']))


def render(template, context, status=200):
    """Renders a template to an HTML response."""
    body = _env.get_template(template).render(**context)
    return web.Response(text=body, content_type='text/html', status=status)


async def _static_handler(request):
    """Serves static files with an EAGER existence check. aiohttp's
    add_static returns an unprepared FileResponse whose 404 materializes at
    send time — after the middlewares ran — so error pages never render for
    missing files; raising here keeps the error-template middleware in the
    loop."""
    rel = request.match_info['static_tail']
    root = STATIC_PATH.resolve()
    path = (root / rel).resolve()
    if not str(path).startswith(str(root) + '/') and path != root:
        raise web.HTTPNotFound()
    if not path.is_file():
        raise web.HTTPNotFound()
    return web.FileResponse(path)


def add_static_routes(app):
    """Mounts the static tree at '/' (register LAST so real routes win)."""
    app.router.add_route('GET', '/{static_tail:.+}', _static_handler)
